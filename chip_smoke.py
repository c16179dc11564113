#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: kernels, predict, train, test.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repository
checkout; no network and no PyYAML. Phases, each printing one JSON line:

  1. env     — device, torch / CUDA / nvcc versions, the card's name and
               power limit; builds csrc/painn_fused.cu, csrc/schnet_fused.cu,
               csrc/qhnet_tp.cu, csrc/escn_layer.cu and csrc/eqv2_attn.cu (one
               nvcc each, started together) and prints each kernel's registers
               and spills.
  2. kernel_A…kernel_H — PaiNN's A (painn_fwd), B (painn_bwd, with and
               without the weight gradient), C (painn_dual_fwd), D
               (painn_dual_bwd, with the weight gradient) and SchNet's E
               (schnet_fwd), F (schnet_bwd, with and without the weight
               gradient), G (schnet_dual_fwd), H (schnet_dual_bwd, with it) at
               each of the predict and train paths' shapes (B=64, A=32/48/64,
               R=100, F=128, fp32; padded atoms and ~30 % of pairs masked; for
               E-H rbf unmasked and the cosine cutoff zero off the edges, as the
               model builds them), one line per kernel and shape: error
               against the plain PyTorch version, and the kernel's, the plain
               version's and the bound's times (CUDA events, median / min /
               max of 25 runs after warm-up); B and F (each with and without
               gW), D and H, A and C, and E and G, are run twice and must give
               the same bits. A-D run their radial products, E-H their
               filter-MLP products, on the tensor cores over the live pairs:
               their lines carry each launched kernel's device ms
               (`stages_ms`). Every line carries the live pairs and `bound_ms`
               with the products at the 3xTF32 rate beside `bound_fma_ms`, as
               I-P's. kernel_I…kernel_L: QHNet's I (qhnet_conv_fwd),
               J (qhnet_conv_bwd), K (qhnet_pair_fwd), L (qhnet_pair_bwd) at the
               QHNet train path's shapes (B=8, A=32/48/64, C=128, LMAX 4, gate
               hiddens 32/32 for the conv and 8/128 for the pair; a/2..a real
               atoms, cgsh from the 12 Bohr radius graph, maskf the full
               graph), the same lines; each runs twice for the same bits and
               its line carries each launched kernel's device ms (`stages_ms`).
               Their bounds count the live pairs (cgsh row or maskf not zero;
               the lines print the count): `bound_ms` with the gate products at
               the 3xTF32 tensor-core rate (as M-P, `tc_bound`), `bound_fma_ms`
               all at the fp32 FMA rate.
  3. predict — for each family, `pipelines.run` of ``job_type: predict`` on
               configs/painn-oc.yaml, then configs/schnet.yaml, at full width
               and depth (hidden 128, 6 interactions, 100 RBF), batch 64,
               buckets 32/48/64, over one seeded DB of 256 molecules (8-62
               atoms, H C N O F S Cl); checks rows, finiteness, launch counts
               (the forward and backward kernel 6x per batch, the backward's
               weight-gradient stage never), the first PREDICT_CPU_MOLS
               molecules of every batch against the CPU plain path, rotation
               invariance / equivariance; molecules/s
               (median / min / max of PASSES passes after a warm-up pass); for
               PaiNN the share of live pairs (rbf_env row not zero) of the
               batches by bucket.
     profile — torch.profiler over two predict steps: device time by
               kernel and the device's busy share (printed before predict);
               PaiNN's must show the engine's products and A's and B's
               stages, SchNet's E's and F's.
  4. train   — for each family, `pipelines.run` of ``job_type: train``
               (TRAIN_EPOCHS epochs, force_grads "pallas") on the same DB,
               then ``job_type: test`` from the best checkpoint; checks launch
               counts (the dual kernels 6x per train step; the forward and
               backward kernels 6x per train step, validation batch and test
               batch; the backward's weight-gradient stage never; the other
               family's kernels never), finite losses, gradient norms and
               test metrics, the checkpoint files; the parameter gradients of
               one batch per bucket against the plain module's double
               backward on the card (force_grads "direct"); molecules/s of
               the train steps of the last epoch (median / min / max), seconds
               per epoch, peak device memory; for PaiNN the live-pair share of
               an epoch's train batches by bucket.
     train_profile — torch.profiler over two train steps (printed before
               train); PaiNN's must show A-D's engine products, their
               stages and D's gW on the engine's weight-gradient product;
               SchNet's the same of E-H (H's gW there).
     painn_optimize — after PaiNN's train phase: `pipelines.run` of
               ``job_type: optimize`` on configs/painn-oc_optim.yaml (full
               width, batch 32, fmax 0.05, memory 100, maxstep 0.2, no line
               search, steps capped at OPT_STEPS) from that phase's best
               checkpoint over the DB's first OPT_MOLS molecules; checks the
               rows (input key-value pairs and data kept; finite positions,
               energies and forces) and launches (A and B 6 x the
               evaluations, Σ over batches of iterations + 1; B's gW stage and
               C-P never); per bucket OPT_CHECK_ITERS iterations of the first
               batch fused and plain on the card (after each iteration E and F
               within the model tolerances of the plain module at the fused
               positions; the two runs' positions within OPT_POS_ATOL after
               OPT_POS_ITERS iterations, and their gap after each iteration
               printed) and the first iteration of its first OPT_CPU_MOLS
               molecules against the CPU plain path (positions within
               OPT_POS_ATOL, E and F as above); one batch
               MT_STEPS steps with the "mt" line search (the reference's c1
               0.23, c2 0.46): every lane finite, A and B once an evaluation;
               molecules/s, batch-iterations/s, the converged share, total
               steps, the mean energy drop and the share of molecules
               lowered, peak memory; torch.profiler over two iterations with
               a full history ring: the device's busy share, the top kernels
               and the two-loop recursion's host ms.
     painn_bf16_optimize — the same job, checkpoint and molecules with
               compute_dtype bfloat16, A-D's plain versions refused: A and B
               in bf16 6 x the evaluations, nothing else; each final bf16 E
               within BF16_E_VS_F32 x max |E| of the fp32 model's at the same
               positions, the mean energy drop positive; the rates, converged
               share, steps and drops beside painn_optimize's.
     painn_profiled_train — PROFILED_STEPS PaiNN train steps through
               `Trainer.fit` with trainer.profile_dir and trainer.log_mfu:
               the Chrome trace (A's stage in it), the card's measured fp32
               matmul peak, the first step's FLOPs (FlopCounterMode's ATen
               operators plus C's and D's FLOP models, those held above
               zero), an MFU per step; A-D as a train phase's.
     painn_pbc — periodic PaiNN (pbc True, PBC_IMAGES images) at painn-oc
               width on `periodic_batch`: E and F against the CPU and under a
               lattice translation of every atom (E_TOL / F_TOL); no kernel.
  SchNet's lines carry the prefix ``schnet_`` (schnet_predict, ...).
  5. qhnet_train — `pipelines.run` of ``job_type: train`` on configs/qhnet.yaml
               at full width (hidden 128, bottle 32, 5 layers, 32 RBF, batch 8,
               atom buckets 32/48/64, orbital buckets 256/384/512/640, EMA
               0.99) over a seeded Hamiltonian DB of 96 molecules (8-62 atoms,
               half H, def2-SVP), TRAIN_EPOCHS epochs, then ``job_type: test``
               from the best checkpoint; checks the I-L launch counts (remat:
               I 10, J 5, K 4, L 2 per train step; I 5, K 2 per validation and
               test batch; no A-H), finite losses and metrics, the checkpoint
               files; per atom bucket, the kernel path's parameter gradients and
               H against the plain module on the card and H's covariance under
               a rotation; molecules/s, seconds per epoch, peak device memory.
     qhnet_train_profile — torch.profiler over two train steps; the gate
               products of I-L must show there as the SO(2) engine's kernels
               (so2_mma_kernel two launches per I-L launch, so2_mmw_kernel)
               and the bodies they replaced must not.
  6. kernel_M, kernel_N — eSCN's M (escn_fwd) and N (escn_bwd) at the eSCN
               paths' shapes (B=64, A=32/48/64), configs/escn-oc.yaml widths
               (l_max 6, m_max 2, C 128, H 256, EC 128), on eSCN-built inputs
               (d from the 8 Å / 40-neighbour graph, xe from a seeded
               EdgeBlock), the same lines with the live pairs counted; the
               plain versions run ESCN_PLAIN_MOLS molecules at a time; N twice
               for the same bits.
     escn_predict — `job_type: predict` on configs/escn-oc.yaml at full width
               and depth (8 layers), batch 64, over the seeded DB: M 8 times
               per batch, N never; per bucket the first batch, and the same
               batch rotated, against the plain module on the card, its first
               molecules against the CPU plain path, E and F within
               ESCN_OUT_RTOL x their largest magnitude; E invariant under the
               rotation, F's equivariance error printed; molecules/s
               (ESCN_PASSES passes).
     escn_profile — torch.profiler over two predict steps.
     escn_train — `job_type: train` (TRAIN_EPOCHS epochs) then `test`: M 8
               per train step, validation and test batch, N 8 per train step;
               finite metrics; per bucket the fused parameter gradients against
               the plain module's on the card, and both against the plain
               module in float64 (printed);
               molecules/s, s/epoch, memory.
     escn_train_profile — torch.profiler over two train steps.
  7. kernel_O, kernel_P — EquiformerV2's O (eqv2_fwd) and P (eqv2_bwd) at the
               EquiformerV2 paths' shapes (B=64, A=32/48/64),
               configs/equiformer_v2.yaml widths (l_max 6, m_max 2, C 128, 8
               heads x 16 value and 64 alpha channels, 3 x 128 edge channels),
               on EquiformerV2-built inputs (idx, d and xe from the 12 Å /
               30-neighbour graph of a seeded one-block model), the same lines
               with the live edges counted; O with dropk ones and a seeded keep
               mask, P every cotangent and twice for the same bits; the plain
               versions run EQV2_PLAIN_MOLS molecules at a time.
     eqv2_predict — `job_type: predict` on configs/equiformer_v2.yaml at full
               width and depth (12 layers), batch 64: O 13 times per batch (12
               blocks and the force block), P never, no dropout drawn; per
               bucket the first batch, and the same batch rotated, against the
               plain module on the card, its first molecule against the CPU
               plain path, E and F within EQV2_OUT_RTOL x their largest
               magnitude; E under the rotation within EQV2_E_ROT x max |E| (the
               model's own grid aliasing), F's equivariance error printed;
               molecules/s (EQV2_PASSES passes).
     eqv2_profile — torch.profiler over two predict steps.
     eqv2_train — `job_type: train` then `test`: O 13 per train step,
               validation and test batch, P 13 per train step, dropout drawn
               13 + 24 times per train step and never in evaluation (each
               mask one torch.rand call, counted), the trainer's generator
               offset moving in train steps and not in validation; finite
               metrics; per bucket, dropout off, the fused parameter gradients
               against the plain module's on the card and both against float64
               (printed); molecules/s, s/epoch, memory.
     eqv2_train_profile — torch.profiler over two train steps.
     kernel_M_bf16 … kernel_P_bf16 — M-P in their bf16 mode (mxu_bf16:
               each product's operands rounded to bf16, one TF32 pass; O/P's
               gathered sender rows and P's per-edge sender cotangents rounded)
               on the fp32 phases' inputs at every bucket, against their plain
               versions in that mode (relative Frobenius error <=
               BF16_SO2_FRO_REL and largest error <= BF16_SO2_MAX_REL x max per
               output), twice for the same bits, the fp32 kernel's distance
               printed; at A=HEADLINE_A the kernel, fp32-kernel and plain
               times and the bounds (the products at the dense bf16 rate).
     escn_bf16, eqv2_bf16 — after both families' fp32 phases, with
               compute_dtype bfloat16 at full width and depth: one epoch of
               `job_type: train`, then `test` and `predict` from its best
               checkpoint, M-P's plain versions refused: the bf16 kernels
               launched as the fp32 paths launch M-P, every other kernel never;
               per bucket E within BF16_E_VS_F32 of the fp32 model on the same
               weights, fused against plain bf16 (BF16_PATHS_TOL), E under a
               rotation; profiles of two predict and two train steps with the
               bf16 launches counted; mol/s, busy shares and peak memory beside
               the fp32 phases'.
     kernel_A_bf16 … kernel_H_bf16 — A-D and E-H in their bf16 mode (bf16
               pair and node tensors; PaiNN's W bf16, SchNet's filter weights
               fp32) on the fp32 phases' inputs rounded to bf16 at every
               bucket, B, F and H with and without gW, against their plain
               versions (BF16_ULP_REL / BF16_MAX_REL), twice for the same bits,
               the live pairs those of fp32; the kernel, fp32-kernel and plain
               times, the FMA bound and the TC bound (the products by their
               operands: bf16 x bf16 at the dense bf16 rate, a bf16 row against
               fp32 in two TF32 passes, fp32 x fp32 at the 3xTF32 rate).
     painn_bf16_train, painn_bf16_predict, schnet_bf16_train,
     schnet_bf16_predict — after the family's fp32 phases, its config with
               compute_dtype bfloat16 at full width: `train` (force_grads
               "pallas"; PaiNN TRAIN_EPOCHS epochs, SchNet one), `test`, then
               `predict` from the best checkpoint, the kernels' plain
               versions refused: the forward and backward kernels in bf16 6
               times a forward, the dual ones 6 times a train step; per bucket
               E within BF16_E_VS_F32 of fp32 on the same weights (PaiNN
               BF16_TRAINED_E_VS_F32), fused against plain bf16
               (BF16_PATHS_TOL), E and F under a rotation (PaiNN
               BF16_TRAINED_ROT_TOL, SchNet SCHNET_BF16_ROT_TOL);
               mol/s, busy shares, peak.
     painn_bf16_headline, schnet_bf16_headline — HEADLINE_STEPS train steps
               at the JAX benchmark's headline shape (256 molecules of 30-48
               atoms, 40 neighbours, force_grads "pallas") in bf16 and fp32.
     gemnet_oc_bf16 (with dimenetpp_bf16, graphormer3d_bf16) — one epoch of
               `train` through the scale fit, `test`, `predict` in bf16; no
               kernel of A-P; E against fp32; the bf16 scale fit within
               GEMNET_BF16_FIT_RTOL of the fp32 phase's.
     dimenetpp_dense — after dimenetpp_train: DimeNet++ with compact False
               (the dense [b, i, j] edge layout) against the compact layout
               on its best checkpoint: one predict batch a bucket (E_TOL /
               F_TOL), one train step's losses and gradients at A=64
               (DENSE_GRAD_RTOL), each layout's peak memory; no kernel.
     eqv2_ref_bf16 — EquiformerV2's reference variant (EQV2_REF_KW) in bf16
               at configs/equiformer_v2.yaml's widths, depth
               EQV2_REF_BF16_LAYERS, batch EQV2_REF_BF16_BATCH: one epoch,
               `test`, `predict`; O and P (and every kernel of A-P) never; E
               within EQV2_REF_BF16_E_VS_F32 of fp32 on the same weights.
  8. phisnet_train — after qhnet_train, over its Hamiltonian DB:
               `job_type: train` on configs/phisnet.yaml at full width (order
               4, 128 features, 128 basis functions, 5 modules, cutoff 15
               Bohr, batch 8, EMA 0.999) with ``trainer.loss_specs`` set to
               H and S (the datamodule reads no core matrix; the core head still
               runs), TRAIN_EPOCHS epochs, then `test` from the best
               checkpoint; no kernel of A-P; finite losses and metrics; per
               atom bucket, on the best checkpoint's weights: H, S and core
               exactly symmetric, the first PH_CPU_MOLS molecules against the
               CPU, every molecule under a rotation against T(R) M T(R)^T, S
               of the other atoms unchanged when a C becomes N; molecules/s,
               seconds per epoch, peak memory.
     phisnet_train_profile — torch.profiler over two train steps.
  9. dimenetpp_train, graphormer3d_train — `job_type: train` (TRAIN_EPOCHS
               epochs) then `test` on configs/dimenetplusplus.yaml (hidden
               256, 6 blocks, K 32, batch 16; forces -dE/dpos by the double
               backward) and configs/graphormer3d.yaml (4 x 6 shared layers,
               512 dim, 32 heads, batch 64; direct forces) at full width over
               the seeded DB: no kernel of A-P; Graphormer3D's dropout drawn
               on train steps only (75 masks a step); finite metrics;
               molecules/s, s/epoch, memory.
     dimenetpp_predict, graphormer3d_predict — `job_type: predict` from that
               train phase's best checkpoint: rows, no kernel, no dropout; per
               bucket the first batch's forces not all 0, its first
               ENERGY_CPU_MOLS molecules against the CPU and the batch rotated
               (E invariant; F covariant for DimeNet++; Graphormer3D's head is
               not covariant by design, its error printed) within E_TOL /
               F_TOL (rtol of the batch's largest magnitude); molecules/s
               (ENERGY_PASSES passes).
     *_profile, *_train_profile — torch.profiler over two predict or train
               steps (the device's busy share).
  10. gemnet_oc_train, gemnet_oc_predict — the same two phases on
               configs/gemnet-oc.yaml at full width (4 blocks, emb 256 / 512,
               128 radial, 7 spherical, K 30 / 8, cutoff 12 Å, coupled direct
               forces, batch 64, loss E L1 + 100 x F L2-norm): the train job
               fits the scale factors from its first scale_fit_batches
               batches; every checkpoint holds the same scales, a refit of
               those batches on the card gives them, the card's fit of the
               first GEMNET_CPU_FIT_MOLS molecules of the smallest of them
               matches the CPU's within GEMNET_FIT_RTOL, two
               train steps leave them as they are, and the gradient norm
               passed the clip; per bucket the fitting path's explicit
               triplet lattice against the factorised path on the card
               within GEMNET_PATHS_TOL; no kernel of A-P.
  11. restore — each over a checkpoint written in the run and found where
               a user's would be (nothing is fetched: urlopen raises), on a
               seeded DB of 64 molecules of 8-32 atoms (one predict batch):
     pretrained_painn — ``pretrained: PaiNN_train_tiny`` (a seeded
               schnetpack-named state dict at configs/painn.yaml width in a
               Lightning .ckpt whose hyper-parameters hold an object of a
               class the loader cannot import, in the cache under its name,
               named by a links file with its MD5) through `pipelines.run` of
               ``job_type: predict``: A and B 6 times, the converted weights
               in the model, the first RESTORE_CPU_MOLS molecules against the
               CPU plain path within E_TOL / F_TOL.
     pretrained_escn, pretrained_eqv2 — the same for a reference-named eSCN
               (configs/escn-oc.yaml width; the converter's XLA layout mapped
               to the fused one: M 8 times) and EquiformerV2 (the published
               variant: m_share_rad False, 600 Gaussians, attention hidden 64;
               the plain path the variant chooses: O and P never), their
               first molecules against the CPU within their predict phases'
               limits.
     flax_restore — a SchNet TrainState (configs/schnet.yaml width, seeded
               weights apart from the job's own, an AdamW chain state)
               written as flax's msgpack by this script; ``job_type: test``
               from it launches E and F 6 times a batch and gives the metrics
               of the same weights carried in as `params` (FLAX_METRIC_RTOL).
     amsgrad_resume — GemNet-OC (configs/gemnet-oc.yaml width) with
               trainer.optimizer amsgrad resumed by ``job_type: train`` from a
               flax TrainState this script writes (seeded weights, an
               amsgrad chain state after AMS_COUNT updates): the trainer
               holds the file's state, one step on the card advances the
               counts and moves the weights; no kernel.
     pretrained_qhnet — ``pretrained: QHNet_train_tiny`` (configs/qhnet.yaml
               width, ref_compat) over qhnet_train's Hamiltonian DB: `test`,
               then QH_RESTORE_STEPS fine-tune steps; I-L as qhnet_train's
               counts; H of the first test molecules on the card within
               QH_H_RTOL x max |H| of the CPU.
  12. data parallelism (painn-oc, force_grads "pallas", A-D in every rank):
     painn_dp_nccl1 — one rank started from the environment as ``torchrun``
               starts one (RANK, WORLD_SIZE 1, LOCAL_RANK, MASTER_ADDR /
               MASTER_PORT): `pipelines.run` starts and tears down an nccl
               group itself; ``train`` (TRAIN_EPOCHS epochs), ``test`` from
               the best checkpoint, then ``predict``: the steps, validation
               and test metrics those of painn_train's one-process run within
               DP_NCCL1_RTOL (a world of one runs no collective; the line says
               whether the bits agree), A-D's counts as painn_train's plus
               the predict batches'.
     painn_dp_gloo2 — two ranks (`spawn`) on the one card in a gloo group
               the phase starts (nccl refuses two ranks on one device):
               DP_STEPS train steps at the global batch BATCH (BATCH / 2
               molecules a rank), then ``test`` and ``predict`` from the last
               checkpoint, against one process on the same global batches and
               weights: the first step's gradients within DP_GRAD_RTOL x
               max |g| per tensor, the test metrics within DP_METRIC_RTOL,
               the predictions (the trained models' E and F on the test
               batches) the same rows in the same order within E_TOL /
               F_TOL; rank 0 alone writes; each rank's A-D counts (6 a layer
               per step, validation, test and predict batch, C and D per
               step only). Correctness, not scaling: both ranks share a card.
     painn_dp_nccl — the same over nccl, one rank a card on min(cards, 4)
               cards, when the machine has two or more; with one card the
               line says it did not run, and the card count.
  13. the multi-card dry run (`nabladft_tpu_torch/dryrun.py`, the counterpart
     of __graft_entry__.py, at its "full" sizes: painn-oc, qhnet and phisnet
     widths):
     dryrun_gloo4 — four ranks (`spawn`) on the one card in a gloo group run
               `dryrun_multichip(4)` once: a dp PaiNN train step, QHNet's
               rmse_mae loss and gradients over a 2×2 dp×mp grid (the dense
               Hamiltonian's orbital rows over mp), `lbfgs_relax` over the dp
               group (4 steps), PhiSNet's H, S and core loss over the grid, a
               dp fit of 8 epochs restored from its checkpoint; rank 0 prints
               every phase's ok line and holds the grid's losses and
               gradients against the unsharded ones. Against one process on
               the same batches and weights (the dry run in a world of one):
               the matrix losses and gradients within DRYRUN_LOSS_RTOL /
               DRYRUN_GRAD_TREE / DRYRUN_GRAD_OWN, the relaxation's steps,
               converged flags, positions (OPT_POS_ATOL) and energies
               (E_TOL), the train step's loss and gradient norm and the
               fit's first validation loss (DP_METRIC_RTOL), its losses
               after 8 epochs and the restore (DRYRUN_FIT_RTOL), beside the
               gaps one-process fits open when only the rows of each batch
               are permuted or each step's gradients get noise of FIT_NOISE
               x the largest |g| (`fit_witnesses`; all three fits' train
               losses step by step against the one process's); each rank's
               launches per phase: A-D
               as the dp phases' for the train step and the fit (11
               validations), A and B 6 per relaxation evaluation with B's gW
               stage never, I-L as qhnet_train's per train step (remat),
               none in PhiSNet's; then A-D and I-L against their plain
               versions (KERNEL_RTOL) at every (B, A) the ranks' and the
               one process's phases gave them (on four ranks A-D at 16/32,
               8/32 and 4/8 a rank and 64/32, 32/32 and 16/8 in one
               process, I-L at 4/32 and 8/32).
     dryrun_nccl — the same over nccl, one rank a card on min(cards, 4)
               cards (a 2×2 grid on four, 1×2 on two); with one card the
               line says it did not run, and the card count.
  14. timing — seconds of each phase; then one JSON object describing every
               ported kernel (A-P) with its launches on each path (0 on the
               paths of 8-10).
Then the card's `nvidia-smi` name and power limit, and last the ok line.
Any failed check raises: the script exits nonzero and prints no ok line.
Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import itertools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_MOLS, MIN_ATOMS, MAX_ATOMS = 256, 8, 62
BATCH, BUCKETS = 64, (32, 48, 64)
TRAIN_EPOCHS = 2
# the optimize job (configs/painn-oc_optim.yaml: batch 32, fmax 0.05, memory
# 100, maxstep 0.2) over the seeded DB's first OPT_MOLS molecules, its steps
# capped at OPT_STEPS (results/optimize_benchmark.json's cap); fused against
# plain over OPT_CHECK_ITERS iterations of one batch per bucket; "mt" over
# MT_STEPS steps with the reference's c1 / c2
OPT_MOLS, OPT_STEPS, OPT_CHECK_ITERS, MT_STEPS, MT_C1, MT_C2 = 64, 100, 3, 10, 0.23, 0.46
# molecules of each bucket's first batch whose first iteration the CPU repeats
# (the CPU evaluates painn-oc at full width: seconds a batch)
OPT_CPU_MOLS = 2
# molecules of each predict batch that the CPU repeats (PaiNN and SchNet)
PREDICT_CPU_MOLS = 8
# Å, the fused and plain runs' positions after OPT_POS_ITERS iterations: the
# runs part as L-BFGS amplifies the forces' rounding (3-5x an iteration at
# painn-oc width; on the H100 at A=32 <= 7.8e-6 Å after 3, 5.3e-5-7.1e-5
# after 5), so the positions
# are held where that growth leaves the limit a wide margin; the kernels
# are held by E and F at the same positions after every iteration
OPT_POS_ATOL, OPT_POS_ITERS = 1e-4, 3
# QHNet (configs/qhnet.yaml): batch 8, atom buckets as above, orbital buckets;
# a seeded Hamiltonian DB of QH_MOLS molecules
QH_BATCH, QH_ORB_BUCKETS, QH_MOLS = 8, (256, 384, 512, 640), 96
QH_C, QH_CONV_H, QH_PAIR_H = 128, (32, 32), (8, 128)
# QHNet kernel path vs the plain module on the card: parameter gradients
# within QH_GRAD_RTOL x max |g| per tensor, H within QH_H_RTOL x max |H|
# (fp32 sums over 65 paths and 5 layers in another order); a rotated batch's
# H against T(R) H T(R)^T within QH_COV_RTOL x max |H|
QH_GRAD_RTOL, QH_H_RTOL, QH_COV_RTOL = 1e-3, 1e-4, 1e-3
# eSCN (configs/escn-oc.yaml) at full width and depth, the datamodule's batch
ESCN_KW = dict(num_layers=8, l_max=6, m_max=2, sphere_channels=128, hidden=256,
               edge_channels=128, cutoff=8.0, max_neighbors=40, num_sphere_samples=128)
# EquiformerV2 (configs/equiformer_v2.yaml) at full width and depth
EQV2_KW = dict(num_layers=12, sphere_channels=128, attn_alpha_channels=64, num_heads=8,
               attn_value_channels=16, ffn_hidden_channels=128, l_max=6, m_max=2, cutoff=12.0,
               max_neighbors=30)
# PhiSNet (configs/phisnet.yaml) at full width, over QHNet's Hamiltonian DB
PHISNET_KW = dict(order=4, num_features=128, num_basis_functions=128, num_modules=5, cutoff=15.0)
# the trainer's loss specs for PhiSNet, as `trainer.loss_specs=...` on the CLI
PHISNET_LOSS_SPECS = {"hamiltonian": "rmse_mae", "overlap": "rmse_mae"}
# DimeNet++ (configs/dimenetplusplus.yaml, batch 16) and Graphormer3D
# (configs/graphormer3d.yaml, model/graphormer3d-small) at full width
DIMENETPP_KW = dict(node_latent_dim=50, hidden=256, num_blocks=6, int_emb_size=64,
                    basis_emb_size=8, out_emb_channels=256, num_spherical=7, num_radial=6,
                    max_neighbors=32, envelope_exponent=5, cutoff=5.0,
                    energy_std=0.870582896669776, energy_mean=-7.349405628928332)
DIMENETPP_BATCH = 16
# GemNet-OC (configs/gemnet-oc.yaml, model/gemnet-oc) at full width
GEMNET_KW = dict(num_blocks=4, emb_size_atom=256, emb_size_edge=512, num_radial=128,
                 num_spherical=7, cutoff=12.0, max_neighbors=30, max_neighbors_qint=8)
GRAPHORMER_KW = dict(blocks=4, layers=6, embed_dim=512, ffn_embed_dim=512, attention_heads=32,
                     input_dropout=0.1, dropout=0.1, attention_dropout=0.0,
                     activation_dropout=0.1, num_kernel=128)
# kernel phase shapes: every (B, A) the predict and train paths give the
# kernels (each batch is padded to B=64 molecules of its bucket's A atoms);
# the kernels line's times are those at A=HEADLINE_A
KB, KR, KF, HEADLINE_A = BATCH, 100, 128, 48
SCHNET_RC = 5.0  # configs/model/schnet.yaml cutoff (Å)
RUNS, WARMUP = 25, 3
# the plain versions of I-P (hundreds of ms a call) are timed over PLAIN_RUNS
# runs after one warm-up: they are the kernels' oracles, no yardstick of speed
PLAIN_RUNS = 2
PASSES = 3  # timed passes of the predict loop, after one warm-up pass
# Kernel vs plain version, both fp32 on the card with sums in another
# order: max |err| <= KERNEL_RTOL * max |plain| per output.
KERNEL_RTOL = 2e-5
# GPU fused path vs the CPU plain path, and rotated vs unrotated inputs:
# the model-level tolerances of the CPU parity tests.
E_TOL = dict(rtol=2e-4, atol=1e-5)
F_TOL = dict(rtol=2e-3, atol=2e-4)
# kernel path (surrogate through A-D or E-H) vs the plain module's double backward,
# per parameter tensor: max |Δg| <= GRAD_RTOL * max |g_plain| (the CPU
# parity tests' surrogate tolerance, tests/train/test_surrogate_grads.py)
GRAD_RTOL = 5e-3

# Published dense peaks (NVIDIA data sheets, full power limit): fp32 FLOP/s
# outside the tensor cores, memory bytes/s, and TF32 FLOP/s on the tensor
# cores (dense: half the sheets' figures with sparsity).
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12, 378e12),
    "H100 NVL": (60e12, 3.9e12, 417.5e12),
    "H100": (67e12, 3.35e12, 494.5e12),  # SXM5 (e.g. "NVIDIA H100 80GB HBM3")
    "H200": (67e12, 4.8e12, 494.5e12),
}
# the SO(2) product engine of M-P runs 3xTF32: three TF32 products per
# fp32-accurate product
TC_PASSES = 3
# dense bf16 FLOP/s on the tensor cores (the same data sheets)
BF16_PEAKS = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100": 989.4e12, "H200": 989.4e12}


def smoke_config(source: str, output_db: str, root: str, config: str = "painn-oc") -> dict:
    """configs/<config>.yaml composed with job_type=predict,
    datamodule.source/root and output_db (the test suite checks this equals
    `load_config` of the file with those overrides; no PyYAML here)."""
    return dict(CONFIGS[config](source, root), job_type="predict", output_db=output_db)


def train_config(source: str, root: str, ckpt_dir: str, output_dir: str,
                 config: str = "painn-oc") -> dict:
    """configs/<config>.yaml composed with job_type=train, datamodule.source/
    root, ckpt_dir, output_dir, trainer.max_epochs=TRAIN_EPOCHS and
    trainer.log_every_n_steps=1 (a CSV row per step; checked against
    `load_config` by the test suite as smoke_config is)."""
    cfg = dict(CONFIGS[config](source, root), job_type="train", ckpt_dir=ckpt_dir,
               output_dir=output_dir)
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=TRAIN_EPOCHS, log_every_n_steps=1)
    return cfg


def optimize_config(source: str, root: str, ckpt_path: str, output_db: str) -> dict:
    """configs/painn-oc_optim.yaml composed with datamodule.source/root,
    ckpt_path, output_db, optimize.steps=OPT_STEPS and
    optimize.line_search=off (checked against `load_config` by the test
    suite)."""
    return {
        "name": "painn-oc-optim", "job_type": "optimize", "seed": 42,
        "datamodule": {"kind": "energy", "source": source, "root": root},
        "optimize": {"batch_size": 32, "fmax": 0.05, "steps": OPT_STEPS, "memory": 100,
                     "maxstep": 0.2, "energy_unit": "Hartree", "position_unit": "Ang",
                     "line_search": "off"},
        "output_db": output_db,
        "model": _painn_oc(source, root)["model"],
        "ckpt_path": ckpt_path,
    }


def _composed(name: str, model: dict, source: str, root: str) -> dict:
    """A top-level config over the default trainer and energy datamodule groups."""
    return {
        "name": name,
        "seed": 42,
        "dataset_name": "dataset_train_tiny",
        "ckpt_dir": f"checkpoints/{name}",
        "output_dir": "outputs",
        "model": model,
        "trainer": {
            "max_epochs": 100, "optimizer": "adamw", "lr": 0.0001, "weight_decay": 0.0,
            "grad_clip": 10.0, "schedule": "plateau", "plateau_factor": 0.8,
            "plateau_patience": 10, "plateau_min_lr": 1e-06, "log_every_n_steps": 50,
            "save_top_k": 3, "monitor": "val/loss", "early_stopping_patience": 50, "seed": 42,
        },
        "datamodule": {"kind": "energy", "source": source, "root": root, "batch_size": BATCH,
                       "val_fraction": 0.1, "bucket_boundaries": list(BUCKETS)},
    }


def _painn_oc(source: str, root: str) -> dict:
    return _composed("painn-oc", {
        "name": "painn",
        "kwargs": {"hidden": 128, "n_interactions": 6, "n_rbf": 100, "cutoff": 5.0,
                   "max_neighbors": 63, "rbf": "gaussian", "envelope": "polynomial",
                   "envelope_exponent": 5},
        "loss_specs": {"energy": "l1", "forces": "l2norm"},
        "loss_coefs": {"energy": 1.0, "forces": 1.0},
    }, source, root)


def _schnet(source: str, root: str) -> dict:
    return _composed("schnet", {
        "name": "schnet",
        "kwargs": {"hidden": 128, "n_interactions": 6, "n_rbf": 100, "cutoff": 5.0,
                   "max_neighbors": 63},
        "loss_specs": {"energy": "mse", "forces": "mse"},
        "loss_coefs": {"energy": 1.0, "forces": 1.0},
    }, source, root)


def _qhnet(source: str, root: str) -> dict:
    """configs/qhnet.yaml: model/qhnet, trainer/default, datamodule/hamiltonian."""
    cfg = _composed("qhnet", {
        "name": "qhnet",
        "kwargs": {"hidden": 128, "bottle_hidden": 32, "num_layers": 5, "radius_cutoff": 12.0,
                   "rbf_dim": 32},
        "loss_specs": {"hamiltonian": "rmse_mae"},
        "loss_coefs": {"hamiltonian": 1.0},
        "trainer_overrides": {"ema_decay": 0.99},
    }, source, root)
    cfg["job_type"] = "train"
    cfg["datamodule"] = {"kind": "hamiltonian", "source": source, "root": root,
                         "batch_size": QH_BATCH, "val_fraction": 0.05,
                         "atom_boundaries": list(BUCKETS),
                         "orbital_boundaries": list(QH_ORB_BUCKETS)}
    return cfg


def _escn_oc(source: str, root: str) -> dict:
    """configs/escn-oc.yaml: model/escn-oc, trainer/default, datamodule/energy."""
    return _composed("escn-oc", {
        "name": "escn", "kwargs": dict(ESCN_KW),
        "loss_specs": {"energy": "l1", "forces": "l2norm"},
        "loss_coefs": {"energy": 1.0, "forces": 100.0},
    }, source, root)


def _eqv2(source: str, root: str) -> dict:
    """configs/equiformer_v2.yaml: model/equiformer_v2, trainer/default, datamodule/energy."""
    return _composed("equiformer_v2", {
        "name": "equiformer_v2", "kwargs": dict(EQV2_KW),
        "loss_specs": {"energy": "l1", "forces": "l2norm"},
        "loss_coefs": {"energy": 1.0, "forces": 100.0},
    }, source, root)


def _phisnet(source: str, root: str) -> dict:
    """configs/phisnet.yaml (model/phisnet, trainer/default,
    datamodule/hamiltonian) with ``trainer.loss_specs={hamiltonian:
    rmse_mae, overlap: rmse_mae}``: the datamodule reads no core matrix, so
    the config's own core loss cannot train (the core head still runs)."""
    cfg = _composed("phisnet", {
        "name": "phisnet", "kwargs": dict(PHISNET_KW),
        "loss_specs": {"hamiltonian": "rmse_mae", "overlap": "rmse_mae", "core": "rmse_mae"},
        "loss_coefs": {"hamiltonian": 1.0, "overlap": 1.0, "core": 1.0},
        "trainer_overrides": {"ema_decay": 0.999, "grad_clip": 0.001},
    }, source, root)
    cfg["trainer"]["loss_specs"] = dict(PHISNET_LOSS_SPECS)
    cfg["job_type"] = "train"
    cfg["datamodule"] = {"kind": "hamiltonian", "source": source, "root": root,
                         "batch_size": QH_BATCH, "val_fraction": 0.05,
                         "atom_boundaries": list(BUCKETS),
                         "orbital_boundaries": list(QH_ORB_BUCKETS)}
    return cfg


def _dimenetpp(source: str, root: str) -> dict:
    """configs/dimenetplusplus.yaml: model/dimenetplusplus, trainer/default,
    datamodule/energy with batch 16."""
    cfg = _composed("dimenetplusplus", {
        "name": "dimenetpp", "kwargs": dict(DIMENETPP_KW),
        "loss_specs": {"energy": "l1", "forces": "l1"},
        "loss_coefs": {"energy": 1.0, "forces": 1.0},
    }, source, root)
    cfg["job_type"] = "train"
    cfg["datamodule"]["batch_size"] = DIMENETPP_BATCH
    return cfg


def _graphormer3d(source: str, root: str) -> dict:
    """configs/graphormer3d.yaml: model/graphormer3d-small, trainer/default,
    datamodule/energy."""
    cfg = _composed("graphormer3d", {
        "name": "graphormer3d", "kwargs": dict(GRAPHORMER_KW),
        "loss_specs": {"energy": "l1", "forces": "l1"},
        "loss_coefs": {"energy": 1.0, "forces": 1.0},
    }, source, root)
    cfg["job_type"] = "train"
    return cfg


def _gemnet_oc(source: str, root: str) -> dict:
    """configs/gemnet-oc.yaml: model/gemnet-oc, trainer/default, datamodule/energy."""
    cfg = _composed("gemnet-oc", {
        "name": "gemnet_oc", "kwargs": dict(GEMNET_KW),
        "loss_specs": {"energy": "l1", "forces": "l2norm"},
        "loss_coefs": {"energy": 1.0, "forces": 100.0},
    }, source, root)
    cfg["job_type"] = "train"
    return cfg


CONFIGS = {"painn-oc": _painn_oc, "schnet": _schnet, "qhnet": _qhnet, "escn-oc": _escn_oc,
           "equiformer_v2": _eqv2, "phisnet": _phisnet, "dimenetplusplus": _dimenetpp,
           "graphormer3d": _graphormer3d, "gemnet-oc": _gemnet_oc}


# the fp32 paths' readings (mol/s, busy share, peak memory) by phase, printed
# beside the bf16 paths'
READINGS: dict = {}
# each family's one-process train job (its final validation and test
# metrics), which painn_dp_nccl1 repeats
ONE_PROCESS: dict = {}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """{kernel: {"registers": n, "static_smem_bytes": n, "spill": "..."}} from
    nvcc -Xptxas -v output (a template kernel's name carries its integer and
    bool arguments, as name<7,0> or name<true>; dynamic shared memory is the
    launch's)."""
    out, name = {}, None
    for line in log.splitlines():
        # <file>_cu_<hash><len><name>, then I L{i,b}<n> E ... E for template arguments
        m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)((?:I(?:L[ib]\d+E|f|13__nv_bfloat16)+E)?)",
                      line)
        if m and ("entry function" in line or "properties for" in line):
            name = m.group(1)
            if m.group(2):  # int and bool arguments, and float / bf16 types
                args = re.findall(r"L([ib])(\d+)E|(f)|(13__nv_bfloat16)", m.group(2)[1:-1])
                name += "<" + ",".join("float" if f else "bf16" if h else
                                       ("false", "true")[int(v)] if k == "b" else v
                                       for k, v, f, h in args) + ">"
            out.setdefault(name, {})
        elif name and "spill stores" in line:
            out[name]["spill"] = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                out[name]["static_smem_bytes"] = int(m.group(1))
    return out


def bf16_peak(name: str) -> float:
    """The card's dense bf16 tensor-core FLOP/s."""
    return next(v for k, v in BF16_PEAKS.items() if k in name)


def peaks(name: str, tensor_cores: bool = False):
    """(fp32 FLOP/s, bytes/s) of the card, and its TF32 FLOP/s with
    `tensor_cores`."""
    for key, val in PEAKS.items():
        if key in name:
            return val if tensor_cores else val[:2]
    raise RuntimeError(f"no published fp32 / memory peak recorded for {name!r}")


def time_ms(fn, runs: int = RUNS, warmup: int = WARMUP) -> dict:
    """CUDA-event times of `fn` (ms): median, min, max over `runs` after
    `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(runs)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in ev)
    return {"median": t[runs // 2], "min": t[0], "max": t[-1]}


def compare(got, ref) -> dict:
    """Max abs error and error relative to the output's largest magnitude."""
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    scale = [float(r.abs().max()) for r in ref]
    return {"max_abs_err": max(errs), "max_rel_err": max(e / max(s, 1e-30)
                                                         for e, s in zip(errs, scale)),
            "per_output_abs_err": errs, "per_output_max_abs": scale}


def _max_abs(t) -> float:
    return float(t.abs().max())


def _grad_errs(model, ref) -> dict:
    """{tensor: max |g - g_ref| / max |g_ref|} over the parameter tensors."""
    return {n: _max_abs(p.grad.double() - q.grad.double()) / max(_max_abs(q.grad), 1e-30)
            for (n, p), (_, q) in zip(model.named_parameters(), ref.named_parameters())}


def kernel_inputs(dev, a: int, b: int = KB):
    """Seeded inputs at one of the paths' kernel shapes (B=b, A=a; the
    predict path's B=KB unless given); the radial chain is a Gaussian basis
    of random distances, ~30% of pairs masked to zero."""
    g = torch.Generator().manual_seed(SEED + a + (0 if b == KB else 1000 * b))

    def mk(*shape):
        return torch.randn(*shape, generator=g) * 0.3

    dist = mk(b, a, a).abs() * 5 + 0.8
    mask = (torch.rand(b, a, a, generator=g) > 0.3).float()
    mu = torch.linspace(0.0, 5.0, KR)
    rbf = torch.exp(-((dist[..., None] - mu) ** 2) / 0.05) * mask[..., None]
    rbfp = (-2.0 / 0.05) * (dist[..., None] - mu) * rbf
    cpu = dict(rbf=rbf, rbfp=rbfp, phi=mk(b, a, 3 * KF), v=mk(b, a, 3 * KF),
               unit_t=mk(b, a, 3, a), w=mk(KR, 3 * KF), gds=mk(b, a, KF),
               gdv=mk(b, a, 3 * KF))
    # the tangent lanes of the dual kernels: rbfd = rbfp * (a distance
    # tangent), as the model builds it
    cpu.update(rbfd=rbfp * mk(b, a, a)[..., None], phid=mk(b, a, 3 * KF),
               vd=mk(b, a, 3 * KF), unitd_t=mk(b, a, 3, a), gdsd=mk(b, a, KF),
               gdvd=mk(b, a, 3 * KF))
    return {k: t.to(dev).contiguous() for k, t in cpu.items()}


C_ARGS = ("rbf", "rbfd", "phi", "phid", "v", "vd", "unit_t", "unitd_t", "w")
D_ARGS = C_ARGS + ("gds", "gdv", "gdsd", "gdvd")


def bound(flops: int, nbytes: int, peak_flops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _kernel_row(shape, err, t_k, t_p, flops, nbytes, peak_flops, peak_bw, **extra) -> dict:
    """One kernel line: errors, kernel / plain / bound times (medians), the
    work counted and the bound's share of the kernel's time."""
    b_ms, b_by = bound(flops, nbytes, peak_flops, peak_bw)
    return dict(shape=shape, **err, ms=t_k["median"], plain_ms=t_p["median"], bound_ms=b_ms,
                bound_by=b_by, flops=flops, bytes=nbytes, roofline_share=b_ms / t_k["median"],
                **extra)


def tc_bound(work: dict, peak_flops: float, peak_bw: float, peak_tf32: float,
             peak_bf16: float):
    """The least time of a kernel's work with its products on the tensor
    cores, priced by their operands, and the rest at the fp32 rate, or its
    bytes at the memory rate: (ms, "operations" or "bytes"). Products of two
    bf16 operands ("flops_live_products_bf16"; all of them in M-P's bf16
    mode, work "products_dtype" bfloat16) at the dense bf16 rate; of a bf16
    row and an fp32 operand ("flops_live_products_bf16_rows": TF32 holds the
    row exactly, so two passes, a·b_hi + a·b_lo, are fp32-accurate) at half
    the TF32 rate; of two fp32 operands at the 3xTF32 rate."""
    prod = work["flops_live_products"]
    if work.get("products_dtype") == "bfloat16":
        both, rows = prod, 0
    else:
        both = work.get("flops_live_products_bf16", 0)
        rows = work.get("flops_live_products_bf16_rows", 0)
    t_ops = (both / peak_bf16 + rows / (peak_tf32 / 2)
             + (prod - both - rows) / (peak_tf32 / TC_PASSES)
             + work["flops_live_other"] / peak_flops) * 1e3
    t_bytes = work["bytes"] / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _so2_row(shape, err, t_k, t_p, work, card: str, **extra) -> dict:
    """A kernel line whose products run on the tensor cores: `bound_ms` the
    tensor-core bound (`tc_bound`: the least time for the same work at its
    operands' precision), `bound_fma_ms` the fp32 FMA one, each with its
    share of the kernel's time."""
    peak_flops, peak_bw, peak_tf32 = peaks(card, tensor_cores=True)
    row = _kernel_row(shape, err, t_k, t_p, work["flops_live"], work["bytes"], peak_flops,
                      peak_bw, **extra)
    b_tc, by_tc = tc_bound(work, peak_flops, peak_bw, peak_tf32, bf16_peak(card))
    row.update(bound_fma_ms=row["bound_ms"], bound_fma_by=row["bound_by"],
               roofline_share_fma=row["roofline_share"], bound_ms=b_tc, bound_by=by_tc,
               roofline_share=b_tc / t_k["median"], flops_products=work["flops_live_products"],
               flops_other=work["flops_live_other"])
    return row


def _same_bits(fn, args, got, what: str) -> None:
    again = fn(*args)
    check(all((p is None and q is None) or torch.equal(p, q) for p, q in zip(got, again)),
          f"{what} gives the same bits on a rerun")


def kernel_bucket(pf, dev, a: int, card: str):
    """Kernels A-D at (KB, a, KR, KF) against their plain versions: errors
    (checked), and kernel / plain / bound times. B is checked and timed both
    with the weight gradient and without it, as the predict path runs it.
    A-D run their radial products on the tensor cores over the live pairs:
    each runs twice for the same bits (B with and without gW) and their
    lines carry each launched kernel's device ms (`stages_ms`). Every line
    carries the live pairs and `bound_ms` with the radial products at the
    3xTF32 rate beside `bound_fma_ms` (`_so2_row`)."""
    x = kernel_inputs(dev, a)
    a_args = [x[k] for k in ("rbf", "phi", "v", "unit_t", "w")]
    b_args = [x[k] for k in ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")]
    shape = [KB, a, KR, KF]

    got = pf.painn_fwd(*a_args)
    err = compare(got, pf.painn_message_reference(*a_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel A error at {shape}: {err}")
    _same_bits(pf.painn_fwd, a_args, got, f"kernel A at {shape}")
    del got
    stages = stage_times(pf.painn_fwd, a_args)
    t_k = time_ms(lambda: pf.painn_fwd(*a_args))
    t_p = time_ms(lambda: pf.painn_message_reference(*a_args))
    work = pf.fwd_work("A", x["rbf"], x["rbf"], KF)
    row_a = _so2_row(shape, err, t_k, t_p, work, card, live_pairs=work["live_pairs"],
                     pairs=work["pairs"], bit_identical_rerun=True, stages_ms=stages)
    emit("kernel_A", **row_a, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)

    got = pf.painn_bwd(*b_args)
    err = compare(got, pf.painn_message_bwd_reference(*b_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel B error at {shape}: {err}")
    _same_bits(pf.painn_bwd, b_args, got, f"kernel B at {shape}")
    got_ng = pf.painn_bwd(*b_args, need_gw=False)
    check(got_ng[4] is None and all(torch.equal(p, q) for p, q in zip(got_ng[:4], got[:4])),
          "kernel B without gW gives the same node and pair cotangents")
    _same_bits(lambda *t: pf.painn_bwd(*t, need_gw=False), b_args, got_ng,
               f"kernel B without gW at {shape}")
    err_ng = compare(got_ng[:4], pf.painn_message_bwd_reference(*b_args, need_gw=False)[:4])
    check(err_ng["max_rel_err"] <= KERNEL_RTOL, f"kernel B (no gW) error at {shape}: {err_ng}")
    del got, got_ng
    stages = stage_times(pf.painn_bwd, b_args)
    stages_ng = stage_times(lambda *t: pf.painn_bwd(*t, need_gw=False), b_args)
    work = pf.bwd_work("B", x["rbf"], x["rbfp"], KF)
    work_ng = pf.bwd_work("B", x["rbf"], x["rbfp"], KF, need_gw=False)
    t_k = time_ms(lambda: pf.painn_bwd(*b_args))
    t_p = time_ms(lambda: pf.painn_message_bwd_reference(*b_args))
    t_k_ng = time_ms(lambda: pf.painn_bwd(*b_args, need_gw=False))
    t_p_ng = time_ms(lambda: pf.painn_message_bwd_reference(*b_args, need_gw=False))
    row_ng = _so2_row(shape, err_ng, t_k_ng, t_p_ng, work_ng, card)
    row_b = _so2_row(shape, err, t_k, t_p, work, card, live_pairs=work["live_pairs"],
                     pairs=work["pairs"], bit_identical_rerun=True, stages_ms=stages,
                     max_abs_err_without_gw=err_ng["max_abs_err"],
                     ms_without_gw=t_k_ng["median"], plain_ms_without_gw=t_p_ng["median"],
                     bound_ms_without_gw=row_ng["bound_ms"],
                     bound_by_without_gw=row_ng["bound_by"],
                     bound_fma_ms_without_gw=row_ng["bound_fma_ms"],
                     flops_without_gw=work_ng["flops_live"],
                     roofline_share_without_gw=row_ng["roofline_share"],
                     stages_ms_without_gw=stages_ng)
    emit("kernel_B", **row_b, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p,
         kernel_times_without_gw=t_k_ng, plain_times_without_gw=t_p_ng)

    c_args = [x[k] for k in C_ARGS]
    got = pf.painn_dual_fwd(*c_args)
    err = compare(got, pf.painn_dual_fwd_reference(*c_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel C error at {shape}: {err}")
    _same_bits(pf.painn_dual_fwd, c_args, got, f"kernel C at {shape}")
    del got
    stages = stage_times(pf.painn_dual_fwd, c_args)
    t_k = time_ms(lambda: pf.painn_dual_fwd(*c_args))
    t_p = time_ms(lambda: pf.painn_dual_fwd_reference(*c_args))
    work = pf.fwd_work("C", x["rbf"], x["rbfd"], KF)
    row_c = _so2_row(shape, err, t_k, t_p, work, card, live_pairs=work["live_pairs"],
                     pairs=work["pairs"], bit_identical_rerun=True, stages_ms=stages)
    emit("kernel_C", **row_c, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)

    d_args = [x[k] for k in D_ARGS]
    got = pf.painn_dual_bwd(*d_args)
    err = compare(got, pf.painn_dual_bwd_reference(*d_args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel D error at {shape}: {err}")
    _same_bits(pf.painn_dual_bwd, d_args, got, f"kernel D at {shape}")
    del got
    stages = stage_times(pf.painn_dual_bwd, d_args)
    work = pf.bwd_work("D", x["rbf"], x["rbfd"], KF)
    t_k = time_ms(lambda: pf.painn_dual_bwd(*d_args))
    t_p = time_ms(lambda: pf.painn_dual_bwd_reference(*d_args))
    row_d = _so2_row(shape, err, t_k, t_p, work, card, live_pairs=work["live_pairs"],
                     pairs=work["pairs"], bit_identical_rerun=True, stages_ms=stages)
    emit("kernel_D", **row_d, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)
    return {"A": row_a, "B": row_b, "C": row_c, "D": row_d}


KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/painn_fused.py)
    "A": ("painn_fwd (A)", 114), "B": ("painn_bwd (B)", 177),
    "C": ("painn_dual_fwd (C)", 286), "D": ("painn_dual_bwd (D)", 372),
}


def kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels A-D at every bucket shape of the predict and train paths. The
    kernels line's numbers are those at A=HEADLINE_A, except max_abs_err,
    the largest over all buckets; `per_bucket` holds each bucket's. Every
    row carries the source's registers and spills (ptxas)."""
    from nabladft_tpu_torch.ops import painn_fused as pf

    per = {k: [] for k in KERNELS}
    for a in BUCKETS:
        for k, row in kernel_bucket(pf, dev, a, card).items():
            per[k].append(row)
        torch.cuda.empty_cache()
    rows = headline_rows(per, KERNELS, "painn_fused", ("B",))
    for k in "ABCD":
        rows[k]["ptxas"] = ptxas.get("painn_fused", {})
    return rows


def headline_rows(per: dict, kernels: dict, source: str, with_gw_split: tuple) -> dict:
    """The kernels line's row of each kernel: numbers at A=HEADLINE_A, except
    max_abs_err, the largest over all buckets; `per_bucket` holds each
    bucket's. `with_gw_split` kernels also carry their without-gW times."""
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "flops", "bytes", "roofline_share")
    tc = ("bound_fma_ms", "bound_fma_by", "roofline_share_fma", "flops_products", "flops_other")
    keep_gw = ("ms_without_gw", "plain_ms_without_gw", "bound_ms_without_gw",
               "roofline_share_without_gw")
    rows = {}
    for k, (name, line) in kernels.items():
        head = next(r for r in per[k] if r["shape"][1] == HEADLINE_A)
        extra = (keep_gw if k in with_gw_split else ()) + (tc if "bound_fma_ms" in head else ())
        extra += ("bound_fma_ms_without_gw",) if "bound_fma_ms_without_gw" in head else ()
        extra += ("live_pairs", "pairs") if "live_pairs" in head else ()
        rows[k] = dict(
            name=name, route="cuda", source=f"nabladft_tpu_torch/csrc/{source}.cu",
            replaces=f"nabladft_tpu/ops/pallas/{source}.py:{line}",
            max_abs_err=max(r["max_abs_err"] for r in per[k]), library_ms=None,
            timed_shape=head["shape"],
            **{f: head[f] for f in keep + extra},
            per_bucket=[{f: r[f] for f in ("shape", "max_abs_err", "max_rel_err") + keep + extra}
                        for r in per[k]],
        )
    return rows


SCHNET_KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/schnet_fused.py)
    "E": ("schnet_fwd (E)", 76), "F": ("schnet_bwd (F)", 89),
    "G": ("schnet_dual_fwd (G)", 127), "H": ("schnet_dual_bwd (H)", 154),
}
E_ARGS = ("rbf", "envf", "xin", "w1", "b1", "w2", "b2")
F_ARGS = ("rbf", "rbfp", "envf", "envp", "xin", "w1", "b1", "w2", "b2", "gmsg")
G_ARGS = ("rbf", "rbfd", "envf", "envfd", "xin", "xind", "w1", "b1", "w2", "b2")
H_ARGS = G_ARGS + ("gmsg", "gmsgd")


def schnet_kernel_inputs(dev, a: int):
    """Seeded inputs of kernels E-H at one of SchNet's kernel shapes (B=KB,
    A=a), built as the model builds them: each molecule has a/2..a real atoms
    (the rest padding), pairs are live within the 5 Å cutoff minus ~30 %
    more masked; rbf is a Gaussian basis NOT masked, envf / envp the cosine
    cutoff and its derivative, zero off the live pairs; the tangent lanes
    rbfd = rbfp ⊙ ṫ and envfd = envp ⊙ ṫ."""
    from nabladft_tpu_torch.ops import radial

    g = torch.Generator().manual_seed(SEED + 1000 + a)

    def mk(*shape):
        return torch.randn(*shape, generator=g) * 0.3

    n_atoms = torch.randint(a // 2, a + 1, (KB,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    dist = mk(KB, a, a).abs() * 8 + 0.8
    live = ((torch.rand(KB, a, a, generator=g) > 0.3) & real[:, :, None] & real[:, None, :]
            & ~torch.eye(a, dtype=torch.bool) & (dist < SCHNET_RC))
    ones, zero = torch.ones_like(dist), torch.zeros_like(dist)
    rbfp = radial.gaussian_rbf_jvp(dist, ones, KR, SCHNET_RC)
    envp = torch.where(live, radial.cosine_cutoff_jvp(dist, ones, SCHNET_RC), zero)
    dt = mk(KB, a, a) * live
    cpu = dict(rbf=radial.gaussian_rbf(dist, KR, SCHNET_RC), rbfp=rbfp,
               envf=torch.where(live, radial.cosine_cutoff(dist, SCHNET_RC), zero), envp=envp,
               rbfd=rbfp * dt[..., None], envfd=envp * dt, xin=mk(KB, a, KF), xind=mk(KB, a, KF),
               w1=torch.randn(KR, KF, generator=g) / KR ** 0.5, b1=mk(1, KF),
               w2=torch.randn(KF, KF, generator=g) / KF ** 0.5, b2=mk(1, KF),
               gmsg=mk(KB, a, KF), gmsgd=mk(KB, a, KF))
    return {k: t.to(dev).contiguous() for k, t in cpu.items()}


def schnet_kernel_bucket(sf, dev, a: int, card: str):
    """Kernels E-H at (KB, a, KR, KF) against their plain versions: errors
    (checked), and kernel / plain / bound times. F is checked and timed with
    the weight gradient and without it (as the predict and force paths run
    it); H with it (as training runs it). E-H run their filter-MLP products
    on the tensor cores over the live pairs: each runs twice for the same
    bits (F with and without gW) and their lines carry each launched
    kernel's device ms (`stages_ms`). Every line carries the live pairs and
    `bound_ms` with the filter-MLP products at the 3xTF32 rate beside
    `bound_fma_ms` (`_so2_row`)."""
    x = schnet_kernel_inputs(dev, a)
    shape = [KB, a, KR, KF]
    rows = {}

    def emit_row(key, row, t_k, t_p, **more):
        row["dynamic_smem_bytes"] = sf.smem_bytes(key, a, KR, KF)
        emit(f"kernel_{key}", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k,
             plain_times=t_p, **more)
        rows[key] = row

    def live(work):
        return dict(live_pairs=work["live_pairs"], pairs=work["pairs"])

    args = [x[k] for k in E_ARGS]
    got = (sf.schnet_fwd(*args),)
    err = compare(got, [sf.schnet_message_reference(*args)])
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel E error at {shape}: {err}")
    _same_bits(lambda *t: (sf.schnet_fwd(*t),), args, got, f"kernel E at {shape}")
    del got
    stages = stage_times(sf.schnet_fwd, args)
    t_k = time_ms(lambda: sf.schnet_fwd(*args))
    t_p = time_ms(lambda: sf.schnet_message_reference(*args))
    work = sf.fwd_work("E", x["rbf"], x["envf"], x["envf"], KF)
    emit_row("E", _so2_row(shape, err, t_k, t_p, work, card, **live(work),
                           bit_identical_rerun=True, stages_ms=stages), t_k, t_p)

    args = [x[k] for k in F_ARGS]
    got = sf.schnet_bwd(*args)
    err = compare(got, sf.schnet_message_bwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel F error at {shape}: {err}")
    _same_bits(sf.schnet_bwd, args, got, f"kernel F at {shape}")
    got_ng = sf.schnet_bwd(*args, need_gw=False)
    check(got_ng[2:] == (None,) * 4 and all(torch.equal(p, q) for p, q in zip(got_ng[:2], got)),
          "kernel F without gW gives the same node and pair cotangents")
    _same_bits(lambda *t: sf.schnet_bwd(*t, need_gw=False), args, got_ng,
               f"kernel F without gW at {shape}")
    err_ng = compare(got_ng[:2], sf.schnet_message_bwd_reference(*args, need_gw=False)[:2])
    check(err_ng["max_rel_err"] <= KERNEL_RTOL, f"kernel F (no gW) error at {shape}: {err_ng}")
    del got, got_ng
    stages = stage_times(sf.schnet_bwd, args)
    stages_ng = stage_times(lambda *t: sf.schnet_bwd(*t, need_gw=False), args)
    work = sf.bwd_work("F", x["rbf"], x["envf"], x["envp"], KF)
    work_ng = sf.bwd_work("F", x["rbf"], x["envf"], x["envp"], KF, need_gw=False)
    t_k = time_ms(lambda: sf.schnet_bwd(*args))
    t_p = time_ms(lambda: sf.schnet_message_bwd_reference(*args))
    t_k_ng = time_ms(lambda: sf.schnet_bwd(*args, need_gw=False))
    t_p_ng = time_ms(lambda: sf.schnet_message_bwd_reference(*args, need_gw=False))
    row_ng = _so2_row(shape, err_ng, t_k_ng, t_p_ng, work_ng, card)
    emit_row("F", _so2_row(
        shape, err, t_k, t_p, work, card, **live(work), bit_identical_rerun=True,
        stages_ms=stages, max_abs_err_without_gw=err_ng["max_abs_err"],
        ms_without_gw=t_k_ng["median"], plain_ms_without_gw=t_p_ng["median"],
        bound_ms_without_gw=row_ng["bound_ms"], bound_by_without_gw=row_ng["bound_by"],
        bound_fma_ms_without_gw=row_ng["bound_fma_ms"], flops_without_gw=work_ng["flops_live"],
        roofline_share_without_gw=row_ng["roofline_share"], stages_ms_without_gw=stages_ng),
        t_k, t_p, kernel_times_without_gw=t_k_ng, plain_times_without_gw=t_p_ng)

    args = [x[k] for k in G_ARGS]
    got = sf.schnet_dual_fwd(*args)
    err = compare(got, sf.schnet_dual_fwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel G error at {shape}: {err}")
    _same_bits(sf.schnet_dual_fwd, args, got, f"kernel G at {shape}")
    del got
    stages = stage_times(sf.schnet_dual_fwd, args)
    t_k = time_ms(lambda: sf.schnet_dual_fwd(*args))
    t_p = time_ms(lambda: sf.schnet_dual_fwd_reference(*args))
    work = sf.fwd_work("G", x["rbf"], x["envf"], x["envfd"], KF)
    emit_row("G", _so2_row(shape, err, t_k, t_p, work, card, **live(work),
                           bit_identical_rerun=True, stages_ms=stages), t_k, t_p)

    args = [x[k] for k in H_ARGS]
    got = sf.schnet_dual_bwd(*args)
    err = compare(got, sf.schnet_dual_bwd_reference(*args))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel H error at {shape}: {err}")
    _same_bits(sf.schnet_dual_bwd, args, got, f"kernel H at {shape}")
    no_gw = sf.schnet_dual_bwd(*args, need_gw=False)
    check(all(torch.equal(p, q) for p, q in zip(no_gw[:2], got)),
          "kernel H without gW gives the same node cotangents")
    del got, no_gw
    stages = stage_times(sf.schnet_dual_bwd, args)
    work = sf.bwd_work("H", x["rbf"], x["envf"], x["envfd"], KF)
    t_k = time_ms(lambda: sf.schnet_dual_bwd(*args))
    t_p = time_ms(lambda: sf.schnet_dual_bwd_reference(*args))
    emit_row("H", _so2_row(shape, err, t_k, t_p, work, card, **live(work),
                           bit_identical_rerun=True, stages_ms=stages), t_k, t_p)
    return rows


def schnet_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels E-H at every bucket shape of SchNet's predict and train paths
    (the kernels line's numbers as in kernel_phases; every row carries the
    source's registers and spills, ptxas)."""
    from nabladft_tpu_torch.ops import schnet_fused as sf

    per = {k: [] for k in SCHNET_KERNELS}
    for a in BUCKETS:
        for k, row in schnet_kernel_bucket(sf, dev, a, card).items():
            per[k].append(row)
        torch.cuda.empty_cache()
    rows = headline_rows(per, SCHNET_KERNELS, "schnet_fused", ("F",))
    for k in "EFGH":
        rows[k]["ptxas"] = ptxas.get("schnet_fused", {})
    return rows


def rotation(seed: int = 5) -> np.ndarray:
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


# the two model families chip_smoke drives: config, kernel module, launch
# counters (forward, backward, backward's gW stage, dual forward, dual
# backward) and the prefix of their phase names
FAMILIES = {
    "painn": dict(config="painn-oc", ops="painn_fused", prefix="",
                  counters=("painn_fwd", "painn_bwd", "painn_bwd_gw", "painn_dual_fwd",
                            "painn_dual_bwd"),
                  # A-D's products on the engine and their stages; D's gW on the
                  # engine's weight-gradient product (train steps only)
                  predict_present=("so2_mma_kernel", "painn_fwd_stage_kernel",
                                   "painn_bwd_stage_kernel"),
                  train_present=("so2_mma_kernel", "painn_fwd_stage_kernel",
                                 "painn_bwd_stage_kernel", "painn_dual_fwd_stage_kernel",
                                 "painn_dual_bwd_stage_kernel", "so2_mmw_kernel")),
    "schnet": dict(config="schnet", ops="schnet_fused", prefix="schnet_",
                   counters=("schnet_fwd", "schnet_bwd", "schnet_bwd_gw", "schnet_dual_fwd",
                             "schnet_dual_bwd"),
                   # E-H's products on the engine and their stages; H's gW on the
                   # engine's weight-gradient product (train steps only)
                   predict_present=("so2_mma_kernel", "schnet_fwd_stage_kernel",
                                    "schnet_bwd_stage_kernel"),
                   train_present=("so2_mma_kernel", "schnet_fwd_stage_kernel",
                                  "schnet_bwd_stage_kernel", "schnet_dual_fwd_stage_kernel",
                                  "schnet_dual_bwd_stage_kernel", "so2_mmw_kernel")),
}


def live_pair_share(model, batches) -> dict:
    """{A: live pairs, pairs, share} over PaiNN batches by bucket: the pairs
    whose rbf_env row is not zero, those kernels A and B work on."""
    out = {}
    with torch.no_grad():
        for batch in batches:
            rbf = model.features(batch.to("cuda"))["rbf_env"]
            b, a = rbf.shape[:2]
            d = out.setdefault(a, {"live_pairs": 0, "pairs": 0})
            d["live_pairs"] += int((rbf != 0).any(-1).sum())
            d["pairs"] += b * a * a
    for d in out.values():
        d["share"] = d["live_pairs"] / d["pairs"]
    return dict(sorted(out.items()))


def reset_all_launches() -> None:
    from nabladft_tpu_torch.ops import eqv2_attn, escn_layer, painn_fused, qhnet_tp, schnet_fused

    painn_fused.reset_launches()
    schnet_fused.reset_launches()
    qhnet_tp.reset_launches()
    escn_layer.reset_launches()
    eqv2_attn.reset_launches()


def all_launches() -> dict:
    from nabladft_tpu_torch.dryrun import launches

    return launches()


def predict_phase(tmp: Path, db: Path, family: str) -> dict:
    """`job_type: predict` of one family over the seeded DB (see the module
    docstring); returns the launch counts of the run."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.models.base import forward
    from nabladft_tpu_torch.train import Trainer

    fam = FAMILIES[family]
    fwd, bwd, bwd_gw = fam["counters"][:3]
    cfg = smoke_config(str(db), str(tmp / f"predictions_{family}.db"), str(tmp),
                       config=fam["config"])

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    res = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    n_batches = res["batches"]
    n_layers = cfg["model"]["kwargs"]["n_interactions"]
    check(res["rows"] == N_MOLS, f"rows written {res['rows']} != {N_MOLS}")
    for k in (fwd, bwd):
        check(launches[k] == n_layers * n_batches,
              f"{k} launched {launches[k]} times, expected {n_layers} x {n_batches} batches")
    check(launches[bwd_gw] == 0, f"{bwd_gw} launched {launches[bwd_gw]} times on predict")
    out_rows = list(AseDatabase(cfg["output_db"]).select_all())
    check(len(out_rows) == N_MOLS, "output DB row count")
    for rec in out_rows:
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(e.shape == (1,) and f.shape == (rec.natoms, 3), "prediction shapes")
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite predictions")

    # the kernels were checked at every shape the main path gave them
    dm = pipelines.build_datamodule(cfg)
    shapes = sorted({tuple(b.z.shape) for b in dm.predict_dataloader()})
    check(all(s in [(KB, a) for a in BUCKETS] for s in shapes),
          f"predict batch shapes {shapes} outside the kernel phase's {BUCKETS}")

    # the first PREDICT_CPU_MOLS molecules of every batch against the CPU
    # plain path with the same seeded weights
    cpu = pipelines.build_model(cfg, torch.device("cpu"))
    check(cpu.use_pallas == "off", "CPU reference runs the plain message")
    cpu.eval()
    e_err = f_err = 0.0
    n_ref = k = 0  # the rows are written in the loader's order
    for batch in dm.predict_dataloader():
        few = _mols(batch, slice(0, PREDICT_CPU_MOLS))
        ref = forward(cpu, few)
        reals = np.flatnonzero(batch.graph_mask.numpy())
        for j, i in enumerate(reals):
            if i >= PREDICT_CPU_MOLS:
                continue
            row, na = out_rows[k + j], int(few.node_mask[i].sum())
            check(np.array_equal(row.numbers, few.z[i, :na].numpy()), "the CPU's row")
            e_gpu, f_gpu = row.data["energy_pred"][0], np.asarray(row.data["forces_pred"])
            e_cpu, f_cpu = float(ref["energy"][i]), ref["forces"][i, :na].numpy()
            np.testing.assert_allclose(e_gpu, e_cpu, **E_TOL)
            np.testing.assert_allclose(f_gpu, f_cpu, **F_TOL)
            e_err = max(e_err, abs(e_gpu - e_cpu))
            f_err = max(f_err, float(np.abs(f_gpu - f_cpu).max()))
            n_ref += 1
        k += len(reals)
    check(n_ref >= n_batches, f"{n_ref} CPU reference molecules over {n_batches} batches")

    # throughput of the predict loop (model on the card): one warm-up pass,
    # then PASSES timed passes over the same loader
    gpu = Trainer(pipelines.build_model(cfg, torch.device("cuda")))
    check(gpu.model.use_pallas == "fused", "the card runs the fused kernels")
    rates = []
    for p in range(PASSES + 1):
        t0 = time.perf_counter()
        n_pred = sum(len(o["energy"]) for o in gpu.predict(dm.predict_dataloader()))
        torch.cuda.synchronize()
        if p:
            rates.append(n_pred / (time.perf_counter() - t0))
    rates.sort()

    # rotation: E invariant, F co-rotates
    batch = next(iter(dm.predict_dataloader())).to("cuda")
    rot = torch.from_numpy(rotation()).cuda()
    out = forward(gpu.model, batch)
    out_r = forward(gpu.model, batch.replace(pos=batch.pos @ rot.T))
    np.testing.assert_allclose(out_r["energy"].cpu().numpy(), out["energy"].cpu().numpy(),
                               **E_TOL)
    np.testing.assert_allclose(out_r["forces"].cpu().numpy(),
                               (out["forces"] @ rot.T).cpu().numpy(), **F_TOL)

    busy = profile_phase(fam["prefix"] + "profile", gpu, dm, present=fam["predict_present"])
    READINGS[fam["prefix"] + "predict"] = dict(molecules_per_second=rates[PASSES // 2],
                                               device_busy_share=busy,
                                               peak_device_memory_bytes=peak_mem)
    live = live_pair_share(gpu.model, dm.predict_dataloader()) if family == "painn" else None
    emit(fam["prefix"] + "predict", config=fam["config"], rows=res["rows"], batches=n_batches,
         live_pairs_by_bucket=live,
         batch_shapes=shapes, launches=launches, run_seconds=res["seconds"],
         cpu_ref_molecules=n_ref, cpu_ref_max_energy_abs_err=e_err,
         cpu_ref_max_force_abs_err=f_err,
         molecules_per_second={"median": rates[PASSES // 2], "min": rates[0],
                               "max": rates[-1], "passes": rates},
         peak_device_memory_bytes=peak_mem, rotation_ok=True,
         tolerances={"energy": E_TOL, "forces": F_TOL})
    return launches


def profile_phase(phase: str, trainer, dm, n_batches: int = 2, top: int = 12,
                  present=()) -> float:
    """torch.profiler over `n_batches` predict steps (bucket 32): device time
    by kernel, and the device's busy share of the wall time (returned); each
    name in `present` must be part of some kernel's name."""
    batches = list(itertools.islice(dm.predict_dataloader(), n_batches))
    return profile_steps(phase, trainer._predict_step, batches, top, present=present)


def profile_steps(phase: str, step, batches, top: int = 12, present=(), absent=(),
                  calls=None) -> float:
    """torch.profiler over `step` on each batch: device time by kernel, and
    the device's busy share of the wall time (returned). Each name in `present` must be
    part of some kernel's name, and none in `absent` of any; `calls()`, read
    after the steps, gives {name: launches} that the kernels whose names
    hold `name` must add up to."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            step(batch.to("cuda"))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's self device time repeats its kernels'
    events = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in events)
    events.sort(key=lambda e: -e[1])
    for name in present:
        check(any(name in k for k, _, _ in events), f"{phase}: no kernel named {name}")
    for name in absent:
        check(not any(name in k for k, _, _ in events), f"{phase}: a kernel named {name}")
    want = calls() if calls else {}
    got = {name: sum(c for k, _, c in events if name in k) for name in want}
    check(got == want, f"{phase}: launches {got}, expected {want}")
    emit(phase, batches=len(batches), batch_shapes=[list(b.z.shape) for b in batches],
         wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
         device_busy_share=device_us / wall_us,
         top=[{"name": k[:80], "device_ms": t / 1e3, "share": t / max(device_us, 1e-9),
               "calls": c} for k, t, c in events[:top]],
         present=list(present), absent=list(absent), calls=got)
    return device_us / wall_us


def read_csv(path: Path) -> list:
    import csv

    with open(path) as f:
        return [{k: float(v) for k, v in row.items() if v != ""} for row in csv.DictReader(f)]


def train_phase(tmp: Path, db: Path, family: str) -> dict:
    """The train and test jobs of one family, then the gradient check and a
    profile of two train steps; returns the launch counts of the run."""
    from nabladft_tpu_torch import pipelines

    fam = FAMILIES[family]
    fwd, bwd, bwd_gw, dual_fwd, dual_bwd = fam["counters"]
    ckpt, outputs = tmp / f"ckpt_{family}", tmp / f"outputs_{family}"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config=fam["config"])
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.time()
    res = pipelines.run(cfg)
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    test = pipelines.run(dict(cfg, job_type="test", ckpt_path=str(ckpt / best)))
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    ONE_PROCESS[family] = dict(res=res, test=test)
    steps, n_layers = res["step"], cfg["model"]["kwargs"]["n_interactions"]
    check(steps == TRAIN_EPOCHS * n_train,
          f"{steps} train steps, expected {TRAIN_EPOCHS} x {n_train}")
    want = dict.fromkeys(launches, 0)  # the other family's kernels: none
    want.update({dual_fwd: n_layers * steps, dual_bwd: n_layers * steps,
                 fwd: n_layers * (steps + TRAIN_EPOCHS * n_val + n_test),
                 bwd: n_layers * (steps + TRAIN_EPOCHS * n_val + n_test), bwd_gw: 0})
    check(launches == want, f"train/test launches {launches}, expected {want}")
    check((ckpt / "last.ckpt").exists() and (ckpt / best).exists(), "checkpoint files")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    check(len(step_rows) == steps and len(val_rows) == TRAIN_EPOCHS, "a CSV row per step and epoch")
    for r in step_rows:
        check(all(np.isfinite(r[k]) for k in ("train/total", "train/energy", "train/forces",
                                              "grad_norm")), f"finite train metrics {r}")
        check(r["skipped_nonfinite"] == 0.0, f"no skipped step {r}")
    for m in [res, test] + val_rows:
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check({"test/loss", "test/energy/mae", "test/forces/mae"} <= set(test), f"test metrics {test}")
    # train-step throughput over the last epoch (every bucket shape seen before)
    rates = sorted(r["mols_per_sec"] for r in step_rows if r["epoch"] == TRAIN_EPOCHS - 1)
    epoch_ends = [t_start] + [r["time"] for r in val_rows]
    epoch_seconds = [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]

    grads = gradient_check(cfg, dm)
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None),
                                      torch.device("cuda"))
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    busy = profile_steps(fam["prefix"] + "train_profile", trainer._train_step, batches,
                         present=fam["train_present"])
    READINGS[fam["prefix"] + "train"] = dict(molecules_per_second=rates[len(rates) // 2],
                                             device_busy_share=busy,
                                             peak_device_memory_bytes=peak_mem)
    live = (live_pair_share(trainer.model, dm.train_dataloader()) if family == "painn"
            else None)
    emit(fam["prefix"] + "train", config=fam["config"], steps=steps, batches_per_epoch=n_train,
         live_pairs_by_bucket=live,
         val_batches=n_val, test_batches=n_test,
         launches=launches, expected_launches=want, final_val=res, test=test,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         grad_norm_max=max(r["grad_norm"] for r in step_rows),
         molecules_per_second={"median": rates[len(rates) // 2], "min": rates[0],
                               "max": rates[-1], "steps": rates, "epoch": TRAIN_EPOCHS - 1},
         seconds_per_epoch=epoch_seconds, peak_device_memory_bytes=peak_mem,
         gradient_check=grads)
    return launches


def gradient_check(cfg: dict, dm) -> list:
    """For the first train batch of each bucket: the parameter gradients of
    the kernel path (force_grads "pallas": A-D or E-H) against the plain module's
    double backward (force_grads "direct") on the card, same seeded weights."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.train import Trainer, TrainerConfig

    dev = torch.device("cuda")
    t = dict(cfg["trainer"], loss_specs=cfg["model"]["loss_specs"],
             loss_coefs=cfg["model"]["loss_coefs"])
    plain_cfg = dict(cfg, model=dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"],
                                                               use_pallas="off")))
    fused = Trainer(pipelines.build_model(cfg, dev), dev,
                    TrainerConfig(**dict(t, force_grads="pallas")))
    plain = Trainer(pipelines.build_model(plain_cfg, dev), dev,
                    TrainerConfig(**dict(t, force_grads="direct")))
    check(fused.model.use_pallas == "fused" and plain.model.use_pallas == "off", "model modes")
    first = {}
    for batch in dm.train_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    out = []
    for a, batch in sorted(first.items()):
        batch = batch.to(dev)
        lf, lp = fused._compute_grads(batch), plain._compute_grads(batch)
        err = _grad_errs(fused.model, plain.model)
        worst_name = max(err, key=err.get)
        worst = err[worst_name]
        check(worst <= GRAD_RTOL, f"gradient check at A={a}: {worst_name} off by {worst:.3e}")
        check(abs(float(lf["total"]) - float(lp["total"])) <= 1e-4 * abs(float(lp["total"])),
              f"loss at A={a}: {float(lf['total'])} vs {float(lp['total'])}")
        out.append({"shape": list(batch.z.shape), "max_rel_grad_err": worst,
                    "worst_param": worst_name, "loss_kernel": float(lf["total"]),
                    "loss_plain": float(lp["total"])})
    check(sorted(first) == list(BUCKETS), f"gradient check buckets {sorted(first)}")
    return out


def _opt_model(cfg: dict, dev, use_pallas: bool):
    """The optimize job's model on `dev` (`build_optimize_model`, as
    `run_optimize_job` builds it), with ``optimize.use_pallas`` set."""
    from nabladft_tpu_torch.optimize.task import build_optimize_model

    model = build_optimize_model(
        dict(cfg, optimize=dict(cfg["optimize"], use_pallas=use_pallas)), dev)
    want = "fused" if use_pallas and dev.type == "cuda" else "off"
    check(model.use_pallas == want, f"optimize model runs {model.use_pallas}, not {want}")
    return model


def optimize_phase(tmp: Path, db: Path) -> dict:
    """`job_type: optimize` of configs/painn-oc_optim.yaml from the best
    checkpoint of the PaiNN train phase over the DB's first OPT_MOLS
    molecules (see the module docstring); returns the launch counts of the
    run."""
    from torch.profiler import ProfilerActivity, profile

    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data import AseDatabase, BucketedLoader, EnergyDataset, LoaderConfig
    from nabladft_tpu_torch.optimize import BatchwiseCalculator, lbfgs_relax
    from nabladft_tpu_torch.optimize.lbfgs import init_lbfgs_state, relax_chunked

    src = tmp / "optimize_in.db"
    seeded, out = AseDatabase(db), AseDatabase(src, create=True)
    try:
        inputs = list(itertools.islice(seeded.select_all(), OPT_MOLS))
        for rec in inputs:
            out.write(rec)
    finally:
        seeded.close()
        out.close()
    ckpt = tmp / "ckpt_painn"
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    cfg = optimize_config(str(src), str(tmp), str(ckpt / best), str(tmp / "optimized.db"))

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    stats = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    n_layers = cfg["model"]["kwargs"]["n_interactions"]
    evals = stats["total_lbfgs_steps"] + stats["batches"]  # Σ_batches (nsteps + 1)
    want = dict.fromkeys(launches, 0)  # B's gW stage and C-P: none
    want.update(painn_fwd=n_layers * evals, painn_bwd=n_layers * evals)
    check(launches == want, f"optimize launches {launches}, expected {want}")
    check(stats["n_molecules"] == OPT_MOLS, f"relaxed {stats['n_molecules']} of {OPT_MOLS}")
    rows = list(AseDatabase(cfg["output_db"]).select_all())
    check(len(rows) == OPT_MOLS, "optimize output row count")
    for rec, inp in zip(rows, inputs):
        check(rec.key_value_pairs == inp.key_value_pairs, "input key-value pairs kept")
        check(set(rec.data) == set(inp.data) | {"model_energy", "model_forces"}, "data keys")
        check(all(np.array_equal(rec.data[k], inp.data[k]) for k in inp.data), "input data kept")
        check(np.array_equal(rec.numbers, inp.numbers), "atomic numbers kept")
        e, f = np.asarray(rec.data["model_energy"]), np.asarray(rec.data["model_forces"])
        check(e.shape == (1,) and f.shape == (rec.natoms, 3), "model energy / forces shapes")
        check(bool(np.isfinite(rec.positions).all() and np.isfinite(e).all()
                   and np.isfinite(f).all()), "finite relaxed rows")

    dev = torch.device("cuda")
    fused = BatchwiseCalculator(_opt_model(cfg, dev, True))
    plain = BatchwiseCalculator(_opt_model(cfg, dev, False))
    cpu = BatchwiseCalculator(_opt_model(cfg, torch.device("cpu"), False))
    o = cfg["optimize"]
    kw = dict(memory=o["memory"], maxstep=o["maxstep"])
    loader = BucketedLoader(EnergyDataset(str(src), root=str(tmp), bucket_boundaries=BUCKETS),
                            config=LoaderConfig(batch_size=o["batch_size"], shuffle=False))
    e_init, first = {}, {}
    for host in loader:
        first.setdefault(host.z.shape[1], host)
        e0, _ = fused(host.to(dev))
        for slot in np.flatnonzero(host.graph_mask.numpy()):
            e_init[int(host.mol_id[slot])] = float(e0[slot])
    check(sorted(first) == list(BUCKETS), f"optimize buckets {sorted(first)}")
    drops = np.array([e_init[inp.id] - rec.data["model_energy"][0]
                      for rec, inp in zip(rows, inputs)])

    # per bucket: OPT_CHECK_ITERS iterations fused and plain on the card,
    # and the first of OPT_CPU_MOLS molecules against the CPU plain path
    checks = []
    for a, host in sorted(first.items()):
        batch = host.to(dev)
        runs = []
        for calc in (fused, plain):
            states = []  # after 0, 1, ... iterations (pos, E and F are fresh tensors a step)
            r, _ = relax_chunked(calc, batch, fmax=o["fmax"], max_steps=OPT_CHECK_ITERS,
                                 interval=1, on_chunk=lambda it, st, ss=states: ss.append(st),
                                 **kw)
            runs.append((r, states))
        (r_f, s_f), (r_p, s_p) = runs
        check(r_f.nsteps == r_p.nsteps, f"A={a}: {r_f.nsteps} vs {r_p.nsteps} iterations")
        gaps = [_max_abs(f.pos - p.pos) for f, p in zip(s_f, s_p)]
        held = gaps[:OPT_POS_ITERS + 1]  # shorter only if every molecule converged first
        check(held[-1] <= OPT_POS_ATOL,
              f"A={a}: fused positions {held[-1]:.3e} Å off plain after {len(held) - 1} "
              "iterations")
        # E and F against the plain module at the fused positions, after
        # every iteration (the two runs' own energies also differ by |F|·|Δx|)
        e_err = f_err = 0.0
        for st in s_f:
            e_p, f_p = plain(batch.replace(pos=st.pos))
            np.testing.assert_allclose(st.energy.cpu().numpy(), e_p.cpu().numpy(), **E_TOL)
            np.testing.assert_allclose(st.forces.cpu().numpy(), f_p.cpu().numpy(), **F_TOL)
            e_err = max(e_err, _max_abs(st.energy - e_p))
            f_err = max(f_err, _max_abs(st.forces - f_p))
        few = _mols(host, slice(0, OPT_CPU_MOLS))
        r_1 = lbfgs_relax(fused, few.to(dev), fmax=o["fmax"], max_steps=1, **kw)
        r_c = lbfgs_relax(cpu, few, fmax=o["fmax"], max_steps=1, **kw)
        cpu_err = _max_abs(r_1.pos.cpu() - r_c.pos)
        check(cpu_err <= OPT_POS_ATOL, f"A={a}: first step {cpu_err:.3e} Å off the CPU")
        e_c, f_c = cpu(few.replace(pos=r_1.pos.cpu()))
        np.testing.assert_allclose(r_1.energy.cpu().numpy(), e_c.numpy(), **E_TOL)
        np.testing.assert_allclose(r_1.forces.cpu().numpy(), f_c.numpy(), **F_TOL)
        checks.append({"shape": list(host.z.shape), "iterations": r_f.nsteps,
                       "plain_pos_gap_by_iteration": gaps,
                       "plain_max_energy_err": e_err, "plain_max_force_err": f_err,
                       "plain_run_max_energy_diff": _max_abs(r_f.energy - r_p.energy),
                       "cpu_first_step_max_pos_err": cpu_err,
                       "cpu_first_step_max_energy_err": _max_abs(r_1.energy.cpu() - e_c)})

    # "mt" (the reference's c1 / c2) on the first batch: A and B once an evaluation
    n_evals = [0]

    def counted(batch):
        n_evals[0] += 1
        return fused(batch)

    batch = first[BUCKETS[0]].to(dev)
    reset_all_launches()
    r_mt = lbfgs_relax(counted, batch, fmax=o["fmax"], max_steps=MT_STEPS, line_search="mt",
                       ls_c1=MT_C1, ls_c2=MT_C2, **kw)
    torch.cuda.synchronize()
    mt_launches = {k: n for k, n in all_launches().items() if n}
    check(mt_launches == {"painn_fwd": n_layers * n_evals[0], "painn_bwd": n_layers * n_evals[0]},
          f"mt launches {mt_launches} for {n_evals[0]} evaluations")
    check(all(bool(torch.isfinite(t).all()) for t in (r_mt.pos, r_mt.energy, r_mt.forces)),
          "every mt lane finite")

    # two iterations with a full ring (the recursion over all `memory` slots)
    # under the profiler, at the largest bucket
    batch = first[BUCKETS[-1]].to(dev)
    state = init_lbfgs_state(fused, batch, 1e-6, o["memory"])._replace(iteration=o["memory"])
    _, state = relax_chunked(fused, batch, fmax=1e-6, max_steps=o["memory"] + 1, interval=1,
                             resume_state=state, **kw)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, state = relax_chunked(fused, batch, fmax=1e-6, max_steps=state.iteration + 2,
                                 interval=2, resume_state=state, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # kernels only: the recursion's named range also shows on the device's
    # track, over the kernels it launched
    events = [(e.key, e.self_device_time_total, e.count) for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
              and e.key != "lbfgs.two_loop"]
    device_us = sum(t for _, t, _ in events)
    events.sort(key=lambda e: -e[1])
    two_loop = [e for e in averages if e.key == "lbfgs.two_loop"
                and e.device_type == torch.autograd.DeviceType.CPU]
    check([e.count for e in two_loop] == [2],
          f"two profiled iterations: {[(e.device_type, e.count) for e in two_loop]}")
    two_loop = two_loop[0]

    READINGS["painn_optimize"] = dict(
        _relax_rates(stats), mean_energy_drop=float(drops.mean()),
        final_energy={inp.id: rec.data["model_energy"][0] for rec, inp in zip(rows, inputs)})
    emit("painn_optimize", config="painn-oc_optim", molecules=stats["n_molecules"],
         batches=stats["batches"], ckpt=best, launches=launches, expected_launches=want,
         evaluations=evals, seconds=stats["seconds"],
         molecules_per_second=stats["n_molecules"] / stats["seconds"],
         batch_iterations_per_second=stats["total_lbfgs_steps"] / stats["seconds"],
         total_lbfgs_steps=stats["total_lbfgs_steps"], n_converged=stats["n_converged"],
         converged_fraction=stats["converged_fraction"],
         mean_energy_drop=float(drops.mean()), share_energy_lowered=float((drops > 0).mean()),
         peak_device_memory_bytes=peak_mem, fused_vs_plain=checks,
         mt={"steps": r_mt.nsteps, "evaluations": n_evals[0], "launches": mt_launches,
             "converged": int(r_mt.converged.sum())},
         profile={"shape": list(batch.z.shape), "iterations": 2, "ring_slots": o["memory"],
                  "wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
                  "device_busy_share": device_us / wall_us,
                  "two_loop_host_ms_per_iteration": two_loop.cpu_time_total / 1e3 / 2,
                  "two_loop_device_ms_per_iteration": two_loop.device_time_total / 1e3 / 2,
                  "top": [{"name": k[:80], "device_ms": t / 1e3, "calls": c}
                          for k, t, c in events[:12]]},
         tolerances={"positions_abs": OPT_POS_ATOL, "positions_after_iterations": OPT_POS_ITERS,
                     "energy": E_TOL, "forces": F_TOL})
    return launches


def _relax_rates(stats: dict) -> dict:
    """A relaxation job's rates and outcome (`BatchwiseOptimizeTask.run`'s stats)."""
    return {"molecules_per_second": stats["n_molecules"] / stats["seconds"],
            "batch_iterations_per_second": stats["total_lbfgs_steps"] / stats["seconds"],
            "converged_fraction": stats["converged_fraction"],
            "total_lbfgs_steps": stats["total_lbfgs_steps"], "seconds": stats["seconds"]}


def optimize_bf16_phase(tmp: Path, db: Path) -> dict:
    """After `painn_optimize`: the same job (its molecules, the PaiNN train
    phase's best checkpoint) with compute_dtype bf16, A-D's plain versions
    refused: A and B in bf16 6 times an energy-and-force evaluation (B
    without its gW stage), every other kernel never; finite rows; each
    molecule's final bf16 energy within BF16_E_VS_F32 x max |E| of the fp32
    model's energy at the same (bf16-relaxed) positions (the bf16 model's
    own E gap, the JAX package's bf16 zoo bound: on trained weights the
    port's bf16 PaiNN lay 0.8-2.0 % of max |E| off fp32,
    tests/painn_bf16_rot_gap.py); the mean energy drop positive. The two
    relaxations' final energies part further (an unconverged L-BFGS
    trajectory amplifies the model gap step by step), so their gap is
    printed, not held; molecules/s, batch-iterations/s, converged share,
    steps and energy drop beside the fp32 run's."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data import AseDatabase, BucketedLoader, EnergyDataset, LoaderConfig
    from nabladft_tpu_torch.optimize import BatchwiseCalculator

    src, ckpt = tmp / "optimize_in.db", tmp / "ckpt_painn"
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    cfg = _bf16_cfg(optimize_config(str(src), str(tmp), str(ckpt / best),
                                    str(tmp / "optimized_bf16.db")))
    dev = torch.device("cuda")

    def energies(calc, path: Path) -> dict:
        """{row id: calc's energy} over the rows of the DB at `path`."""
        loader = BucketedLoader(EnergyDataset(str(path), root=str(tmp), bucket_boundaries=BUCKETS),
                                config=LoaderConfig(batch_size=cfg["optimize"]["batch_size"],
                                                    shuffle=False))
        out = {}
        for host in loader:
            e, _ = calc(host.to(dev))
            for slot in np.flatnonzero(host.graph_mask.numpy()):
                out[int(host.mol_id[slot])] = float(e[slot])
        return out

    with no_plain("painn"):
        # the main path: counts reset just before, read just after
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        stats = pipelines.run(cfg)
        torch.cuda.synchronize()
        launches = all_launches()
        peak_mem = torch.cuda.max_memory_allocated()
        calc = BatchwiseCalculator(_opt_model(cfg, dev, True))
        check(calc.model.cdt == torch.bfloat16, "the bf16 relaxation's model computes in bf16")
        e_init = energies(calc, src)
    n_layers = cfg["model"]["kwargs"]["n_interactions"]
    evals = stats["total_lbfgs_steps"] + stats["batches"]
    want = dict.fromkeys(launches, 0)
    want.update(painn_fwd_bf16=n_layers * evals, painn_bwd_bf16=n_layers * evals)
    check(launches == want, f"bf16 optimize launches {launches}, expected {want}")
    check(stats["n_molecules"] == OPT_MOLS, f"relaxed {stats['n_molecules']} of {OPT_MOLS}")
    f32 = READINGS["painn_optimize"]
    rows = list(AseDatabase(cfg["output_db"]).select_all())
    final = {rec.id: rec.data["model_energy"][0] for rec in rows}
    check(sorted(final) == sorted(f32["final_energy"]) == sorted(e_init), "the same molecules")
    for rec in rows:
        check(bool(np.isfinite(rec.positions).all()
                   and np.isfinite(rec.data["model_forces"]).all()), "finite bf16 relaxed rows")
    ids = sorted(final)
    e16 = np.array([final[k] for k in ids])
    at16 = energies(BatchwiseCalculator(_opt_model(_f32_cfg(cfg), dev, True)),
                    Path(cfg["output_db"]))
    e32_at16 = np.array([at16[k] for k in ids])
    model_gap = float(np.abs(e16 - e32_at16).max() / np.abs(e32_at16).max())
    e32 = np.array([f32["final_energy"][k] for k in ids])
    relax_gap = float(np.abs(e16 - e32).max() / np.abs(e32).max())
    drops = np.array([e_init[k] - final[k] for k in ids])
    emit("painn_bf16_optimize", config="painn-oc_optim", compute_dtype="bfloat16",
         molecules=stats["n_molecules"], batches=stats["batches"], ckpt=best,
         launches=launches, expected_launches=want, evaluations=evals,
         **_relax_rates(stats), n_converged=stats["n_converged"],
         mean_energy_drop=float(drops.mean()), share_energy_lowered=float((drops > 0).mean()),
         final_energy_rel_err_vs_fp32_model=model_gap,
         final_energy_rel_diff_vs_fp32_relaxation=relax_gap,
         mean_final_energy={"bf16": float(e16.mean()), "fp32": float(e32.mean())},
         peak_device_memory_bytes=peak_mem,
         fp32={k: v for k, v in f32.items() if k != "final_energy"},
         tolerances={"final_energy_vs_fp32_model": BF16_E_VS_F32})
    check(model_gap <= BF16_E_VS_F32,
          f"bf16 final energies {model_gap} of max |E| off the fp32 model's there")
    check(drops.mean() > 0, f"the bf16 relaxation lowered E on average ({drops.mean()})")
    return launches


# periodic PaiNN: PBC_MOLS seeded molecules of PBC_ATOMS // 2 to PBC_ATOMS
# atoms at uniform fractional positions in skewed cells of ~PBC_CELL Å (each
# atom meets periodic images, its own too, within the 5 Å cutoff). The
# translation check moves each atom by a lattice vector of 0 or 1 cell along
# each axis, so a pair's image may move by one cell: PBC_IMAGES images each
# way keep every in-cutoff pair of either placement
PBC_MOLS, PBC_ATOMS, PBC_CELL, PBC_IMAGES = 16, 24, 6.0, 2


def periodic_batch(seed: int):
    from nabladft_tpu_torch.data.batch import MolBatch

    rng = np.random.default_rng(seed)
    cell = (np.eye(3) * PBC_CELL + rng.normal(0, 0.3, (PBC_MOLS, 3, 3))).astype(np.float32)
    n = rng.integers(PBC_ATOMS // 2, PBC_ATOMS + 1, PBC_MOLS)
    node_mask = np.arange(PBC_ATOMS)[None] < n[:, None]
    pos = (rng.uniform(0, 1, (PBC_MOLS, PBC_ATOMS, 3)) @ cell) * node_mask[..., None]
    z = np.where(node_mask, rng.choice([1, 6, 7, 8], (PBC_MOLS, PBC_ATOMS)), 0)
    return MolBatch(z=torch.from_numpy(z.astype(np.int32)),
                    pos=torch.from_numpy(pos.astype(np.float32)),
                    node_mask=torch.from_numpy(node_mask),
                    graph_mask=torch.ones(PBC_MOLS, dtype=torch.bool),
                    energy=torch.zeros(PBC_MOLS), forces=torch.zeros(PBC_MOLS, PBC_ATOMS, 3),
                    mol_id=torch.arange(PBC_MOLS, dtype=torch.int32),
                    cell=torch.from_numpy(cell))


def pbc_phase(tmp: Path) -> dict:
    """PaiNN with pbc True and PBC_IMAGES images (configs/painn-oc.yaml
    width, seeded weights) over `periodic_batch`: E and F on the card against
    the CPU within E_TOL / F_TOL, and unchanged (E_TOL / F_TOL) when every
    atom moves by a seeded lattice vector; the periodic path runs no kernel
    of A-P (plain torch, as the JAX model's)."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.models.base import forward

    cfg = _painn_oc("", str(tmp))
    cfg["model"]["kwargs"] = dict(cfg["model"]["kwargs"], pbc=True, pbc_images=PBC_IMAGES)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    model = pipelines.build_model(cfg, dev).eval()
    check(model.pbc and model.use_pallas == "off", "the periodic PaiNN runs the plain path")
    host = periodic_batch(SEED + 7)
    batch = host.to(dev)
    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = forward(model, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()
    check(not any(launches.values()), f"periodic PaiNN launched kernels of A-P: {launches}")
    ref = pipelines.build_model(cfg, cpu).eval()
    ref.load_state_dict(model.state_dict())
    out_c = forward(ref, host)
    np.testing.assert_allclose(out["energy"].cpu().numpy(), out_c["energy"].numpy(), **E_TOL)
    np.testing.assert_allclose(out["forces"].cpu().numpy(), out_c["forces"].numpy(), **F_TOL)
    shift = np.random.default_rng(SEED + 8).integers(0, 2, (PBC_MOLS, PBC_ATOMS, 3))
    moved = batch.pos + torch.einsum("bax,bxy->bay", torch.from_numpy(shift).to(dev).float(),
                                     batch.cell) * batch.node_mask[..., None]
    out_t = forward(model, batch.replace(pos=moved))
    np.testing.assert_allclose(out_t["energy"].cpu().numpy(), out["energy"].cpu().numpy(),
                               **E_TOL)
    np.testing.assert_allclose(out_t["forces"].cpu().numpy(), out["forces"].cpu().numpy(),
                               **F_TOL)
    nl = model.features(batch)["nl"]
    emit("painn_pbc", config="painn-oc + pbc", shape=list(batch.z.shape),
         neighbour_slots=int(nl.idx.shape[-1]), edges=int(nl.mask.sum()),
         image_edges=int((nl.offset != 0).any(-1).sum()), launches=launches,
         forward_and_forces_seconds=seconds, peak_device_memory_bytes=peak_mem,
         energy_max_abs_err_vs_cpu=_max_abs(out["energy"].cpu() - out_c["energy"]),
         forces_max_abs_err_vs_cpu=_max_abs(out["forces"].cpu() - out_c["forces"]),
         energy_max_abs_diff_translated=_max_abs(out_t["energy"] - out["energy"]),
         forces_max_abs_diff_translated=_max_abs(out_t["forces"] - out["forces"]),
         tolerances={"energy": E_TOL, "forces": F_TOL})
    return launches


# DimeNet++'s dense layout against the compact one, one train step's
# parameter gradients per tensor: max |Δg| <= DENSE_GRAD_RTOL x max |g|
# (tests/test_torch_dimenetpp.py's G_REL; both layouts against JAX there)
DENSE_GRAD_RTOL = 2e-3


def dimenetpp_dense_phase(tmp: Path, db: Path) -> dict:
    """DimeNet++ (configs/dimenetplusplus.yaml width) with compact False (the
    dense [b, i, j] edge layout) against the compact layout on the
    dimenetpp train phase's best checkpoint: the first predict batch of each
    bucket (E and F within E_TOL's / F_TOL's rtol x the batch's largest
    magnitude: the layouts sum in other orders, and a molecule's E is a sum
    that may cancel far below the batch's) and one train step's losses and
    parameter gradients on the first train batch of the largest bucket
    (DENSE_GRAD_RTOL); each layout's peak memory over that step; no kernel
    of A-P."""
    from nabladft_tpu_torch import pipelines

    ckpt = tmp / "ckpt_dimenetpp"
    best = ckpt / json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    base = train_config(str(db), str(tmp), "", "", config="dimenetplusplus")
    dm = pipelines.build_datamodule(base)
    dev = torch.device("cuda")
    first = _first_batches(dm.predict_dataloader(), dev)
    train_batch = next(b for b in dm.train_dataloader() if b.z.shape[1] == BUCKETS[-1]).to(dev)
    runs, launches = {}, {}
    for layout, compact in (("compact", True), ("dense", False)):
        m = base["model"]
        cfg = dict(base, model=dict(m, kwargs=dict(m["kwargs"], compact=compact)),
                   log_csv=False, ckpt_dir=None)
        trainer = pipelines.build_trainer(cfg, dev)
        trainer.load_checkpoint(best)
        check(trainer.model.compact == compact, f"DimeNet++ {layout} layout")
        # the main path: counts reset just before, read just after
        reset_all_launches()
        outs = {a: _outputs(trainer.model.eval(), b) for a, b in first.items()}
        trainer.model.train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = trainer._compute_grads(train_batch)
        torch.cuda.synchronize()
        launches[layout] = all_launches()
        check(not any(launches[layout].values()), f"DimeNet++ {layout} launched kernels")
        runs[layout] = dict(outs=outs, losses={k: float(v) for k, v in losses.items()},
                            grads={n: p.grad.detach().clone()
                                   for n, p in trainer.model.named_parameters()},
                            peak=torch.cuda.max_memory_allocated())
        del trainer
    c, d = runs["compact"], runs["dense"]
    rows = []
    for a in sorted(first):
        row = {"shape": list(first[a].z.shape)}
        for k, tol in (("energy", E_TOL), ("forces", F_TOL)):
            row[f"{k}_rel_err"] = _rel_err(d["outs"][a], c["outs"][a], k)
            check(row[f"{k}_rel_err"] <= tol["rtol"], f"DimeNet++ dense {k} at A={a}: {row}")
        rows.append(row)
    for k in c["losses"]:
        check(abs(d["losses"][k] - c["losses"][k]) <= E_TOL["rtol"] * abs(c["losses"][k])
              + E_TOL["atol"], f"DimeNet++ dense loss {k}: {d['losses'][k]} vs {c['losses'][k]}")
    grad_err = max(_max_abs(d["grads"][n] - g) / max(_max_abs(g), 1e-30)
                   for n, g in c["grads"].items())
    check(grad_err <= DENSE_GRAD_RTOL, f"DimeNet++ dense gradients {grad_err} of max |g| off")
    emit("dimenetpp_dense", config="dimenetplusplus + compact false", predict=rows,
         train_shape=list(train_batch.z.shape), losses={k: r["losses"] for k, r in runs.items()},
         grad_max_rel_err=grad_err,
         train_step_peak_device_memory_bytes={k: r["peak"] for k, r in runs.items()},
         tolerances={"energy_rel": E_TOL["rtol"], "forces_rel": F_TOL["rtol"],
                     "losses": E_TOL, "grad_rel": DENSE_GRAD_RTOL})
    return launches["dense"]


PROFILED_STEPS = 4  # train steps of the profiled PaiNN run


def profiled_train_phase(tmp: Path, db: Path) -> dict:
    """One short PaiNN train (configs/painn-oc.yaml, PROFILED_STEPS steps,
    force_grads "pallas") with trainer.profile_dir and trainer.log_mfu
    through `Trainer.fit`: the peak the trainer measures on the card (an fp32
    matmul, TF32 off as everywhere in this script), the first step's FLOPs
    (torch's counter over its ATen operators plus C's and D's own FLOP models
    for each launch: C and D are no ATen operators), each logged step's MFU
    finite and positive, the Chrome trace written with A-D's stages in it;
    A-D launched as a train phase's; the card's name and power limit."""
    from nabladft_tpu_torch import pipelines

    outputs, prof = tmp / "outputs_profiled", tmp / "profile_painn"
    cfg = train_config(str(db), str(tmp), "", str(outputs))
    cfg["ckpt_dir"] = None
    cfg["trainer"] = dict(cfg["trainer"], max_steps=PROFILED_STEPS, profile_dir=str(prof),
                          log_mfu=True)
    dm = pipelines.build_datamodule(cfg)
    n_val = len(dm.val_dataloader())
    trainer = pipelines.build_trainer(cfg, torch.device("cuda"))
    # the main path: counts reset just before, read just after
    reset_all_launches()
    t0 = time.perf_counter()
    try:
        trainer.fit(dm)
    finally:
        trainer.loggers.finalize()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    n_layers = cfg["model"]["kwargs"]["n_interactions"]
    want = _want(launches, painn_fwd=n_layers * (PROFILED_STEPS + n_val),
                 painn_bwd=n_layers * (PROFILED_STEPS + n_val),
                 painn_dual_fwd=n_layers * PROFILED_STEPS,
                 painn_dual_bwd=n_layers * PROFILED_STEPS)
    check(launches == want, f"profiled train launches {launches}, expected {want}")
    rows = [r for r in read_csv(outputs / cfg["name"] / "metrics.csv") if "train/total" in r]
    mfus = [r["mfu"] for r in rows]
    check(len(rows) == PROFILED_STEPS and all(np.isfinite(u) and u > 0 for u in mfus),
          f"an mfu per logged step: {mfus}")
    check(0 < trainer.kernel_flops < trainer.step_flops,
          f"the first step's FLOPs {trainer.step_flops} hold C's and D's {trainer.kernel_flops}")
    trace = prof / "trace.json"
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    check(any("painn_fwd_stage_kernel" in n for n in names), "A's stage in the trace")
    emit("painn_profiled_train", config="painn-oc", steps=PROFILED_STEPS, seconds=seconds,
         launches=launches, measured_peak_flops=trainer.peak_flops,
         peak_dtype=str(trainer.model.cdt), first_step_counted_flops=trainer.step_flops,
         first_step_kernel_flops=trainer.kernel_flops,
         mfu_by_step=mfus, trace_bytes=trace.stat().st_size, trace_events=len(names),
         card=nvidia_smi())
    return launches


AMS_COUNT = 5  # updates the written amsgrad state has applied


def amsgrad_resume_phase(tmp: Path, db: Path) -> dict:
    """GemNet-OC (configs/gemnet-oc.yaml width) with trainer.optimizer
    amsgrad, resumed by `job_type: train` with ``ckpt_path`` from a flax
    TrainState this script writes as the JAX engine would (seeded weights,
    scale factors 1, the clip then inject_hyperparams(amsgrad) chain state
    with seeded moments after AMS_COUNT updates): the trainer's amsgrad
    state is the file's; the job takes one step on the card (step and
    update counts AMS_COUNT + 1, nu_max nowhere below the file's, every
    weight finite, the weights moved); no kernel of A-P."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.models.convert import flax_params_of, flax_tensors

    ckpt = tmp / "ckpt_amsgrad"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(tmp / "outputs_amsgrad"),
                       config="gemnet-oc")
    cfg["trainer"] = dict(cfg["trainer"], optimizer="amsgrad", max_steps=AMS_COUNT + 1)
    seeded = dict(cfg, trainer=dict(cfg["trainer"], seed=SEED + 9))
    params = flax_params_of(pipelines.build_model(seeded, torch.device("cpu")))
    rng = np.random.default_rng(SEED + 9)

    def like(tree, fn):
        return {k: like(v, fn) if isinstance(v, dict) else np.asarray(fn(v), np.float32)
                for k, v in tree.items()}

    mu = like(params, lambda v: rng.normal(0, 1e-4, v.shape))
    nu = like(params, lambda v: rng.uniform(1e-9, 1e-7, v.shape))
    nu_max = like(nu, lambda v: v / (1 - 0.999 ** AMS_COUNT))
    count = np.array(AMS_COUNT, np.int32)
    state = {"step": count, "params": params, "ema_params": None,
             "opt_state": {"0": {}, "1": {
                 "count": count, "hyperparams": {"learning_rate": np.array(1e-4, np.float32)},
                 "hyperparams_states": {},
                 "inner_state": {"0": {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max},
                                 "1": {}}}}}
    path = tmp / "gemnet_amsgrad_flax.ckpt"
    path.write_bytes(_msgpack(state))

    dev = torch.device("cuda")
    probe = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None), dev)
    probe.load_checkpoint(path, resume=True)
    want_max = flax_tensors(probe.model, nu_max)
    names = [n for n, p in probe.model.named_parameters() if n not in probe.scales]
    loaded = {n: probe.optimizer.state[p] for n, p in probe.model.named_parameters()
              if n in names}
    check(probe.step == AMS_COUNT and probe.applied == AMS_COUNT
          and all(st["step"] == AMS_COUNT and torch.equal(st["nu_max"].cpu(), want_max[n])
                  for n, st in loaded.items()), "the trainer's amsgrad state is the file's")
    del probe
    # the main path: counts reset just before, read just after
    reset_all_launches()
    res = pipelines.run(dict(cfg, ckpt_path=str(path)))
    torch.cuda.synchronize()
    launches = all_launches()
    check(not any(launches.values()), f"gemnet_oc launched kernels of A-P: {launches}")
    check(res["step"] == AMS_COUNT + 1, f"resumed at {AMS_COUNT}, ended at {res['step']}")
    saved = torch.load(ckpt / "last.ckpt", map_location="cpu", weights_only=True)
    opt = saved["optimizer"]["state"]
    check(len(opt) == len(names) and all(int(opt[i]["step"]) == AMS_COUNT + 1
                                          and bool((opt[i]["nu_max"] >= want_max[n]).all())
                                          for i, n in enumerate(names)),
          "one amsgrad update from the file's state")
    before = flax_tensors(pipelines.build_model(seeded, torch.device("cpu")), params)
    moved = max(_max_abs(saved["model"][n] - before[n]) for n in names)
    check(moved > 0 and all(bool(torch.isfinite(t).all()) for t in saved["model"].values()),
          f"the step moved the weights ({moved}) and left them finite")
    emit("amsgrad_resume", config="gemnet-oc + amsgrad", checkpoint_bytes=path.stat().st_size,
         resumed_step=AMS_COUNT, final=res, launches=launches, weights_max_abs_move=moved)
    return launches


QHNET_KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/qhnet_tp.py)
    "I": ("qhnet_conv_fwd (I)", 200), "J": ("qhnet_conv_bwd (J)", 226),
    "K": ("qhnet_pair_fwd (K)", 414), "L": ("qhnet_pair_bwd (L)", 448),
}
QH_ARGS = {
    "I": ("x", "cgsh", "hr_c", "hs_c", "w2r_c", "b2r_c", "w2s_c", "b2s_c"),
    "K": ("x", "zi", "maskf", "hr_p", "hs_p", "w2r_p", "b2r_p", "w2s_p", "b2s_p"),
}
QH_ARGS.update(J=QH_ARGS["I"] + ("g_conv",), L=QH_ARGS["K"] + ("g_pair",))


def qhnet_kernel_inputs(dev, b: int, a: int, c: int, hc=QH_CONV_H, hp=QH_PAIR_H,
                        seed: int = SEED) -> dict:
    """Seeded inputs of kernels I-L, built as QHNet builds them: each
    molecule has a/2..a real atoms (the rest padding) at random positions
    (Bohr); cgsh = the edge SH (component-normalized, zero off the 12 Bohr
    radius graph) @ cgsh_matrix; zi = node @ cgz_matrix of the same node
    features as x; maskf the full-graph mask (no self pairs, no padding);
    gate hiddens, weights and cotangents random. Also node_mask and adj."""
    from nabladft_tpu_torch.ops import qhnet_tp as qt, so3

    g = torch.Generator().manual_seed(seed)

    def mk(*shape, scale=0.3):
        return torch.randn(*shape, generator=g) * scale

    lmax, s = qt.LMAX, qt.S
    pc = len(qt.tp_paths(lmax)) * c
    n_atoms = torch.randint(max(a // 2, 1), a + 1, (b,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    pos = mk(b, a, 3, scale=4.0)
    diff = pos[:, None] - pos[:, :, None]
    dist = diff.norm(dim=-1)
    full = real[:, :, None] & real[:, None, :] & ~torch.eye(a, dtype=torch.bool)
    adj = full & (dist < 12.0)
    unit = torch.where(full[..., None], diff / dist.clamp(min=1e-9)[..., None], 0.0)
    sh = so3.real_sph_harm(unit, lmax, normalized=False)
    cgsh = torch.where(adj[..., None], sh, 0.0) @ torch.from_numpy(qt.cgsh_matrix(lmax))
    node = mk(b, a, s, c) * real[:, :, None, None]
    zi = torch.einsum("basc,sk->bakc", node, torch.from_numpy(qt.cgz_matrix(lmax)))
    x = dict(x=node.transpose(1, 2), cgsh=cgsh, zi=zi, maskf=full.float()[..., None],
             g_conv=mk(b, a, s, c), g_pair=mk(b, a, s, a, c), node_mask=real, adj=adj)
    for tag, (h1, h2) in (("c", hc), ("p", hp)):
        x.update({f"hr_{tag}": mk(b, a, a, h1, scale=1.0), f"hs_{tag}": mk(b, a, a, h2, scale=1.0),
                  f"w2r_{tag}": mk(h1, pc, scale=h1 ** -0.5),
                  f"w2s_{tag}": mk(h2, pc, scale=h2 ** -0.5),
                  f"b2r_{tag}": mk(pc, scale=0.1), f"b2s_{tag}": mk(pc, scale=0.1)})
    return {k: t.to(dev).contiguous() for k, t in x.items()}


def escn_kernel_inputs(dev, b: int, a: int, seed: int = SEED, **kw) -> dict:
    """Seeded inputs of kernels M and N, built as eSCN builds them (widths of
    configs/escn-oc.yaml unless `kw` shrinks them): each molecule has a/2..a
    real atoms (the rest padding, z = 0) of H C N O at random positions (Å,
    ~10 Å across); d = the compact truncated Wigner values of the 8 Å /
    40-neighbour graph's edge frames, zero off the graph; xe from a seeded
    layer's EdgeBlock; that layer's weights `ws`; x and the cotangent g
    random. Also node_mask and the pair mask."""
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.ops import graph, so3
    from nabladft_tpu_torch.train import seeded_generator

    cfg = dict(ESCN_KW, num_layers=1, **kw)
    g = torch.Generator().manual_seed(seed)
    n_atoms = torch.randint(max(a // 2, 1), a + 1, (b,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    zs = torch.tensor([1, 6, 7, 8])[torch.randint(0, 4, (b, a), generator=g)] * real
    pos = torch.randn(b, a, 3, generator=g) * 2.5 * real[..., None]
    model = create_model("escn", device="cpu", generator=seeded_generator(seed), **cfg)
    layer = model.layers[0]
    nl = graph.neighbor_list(pos, real, cfg["cutoff"], cfg["max_neighbors"])
    mask_d, unit_d, dist_d = graph.dense_from_neighbor_list(nl, a)
    d = so3.wigner_trunc_compact_from_rot(so3.rot_to_z(unit_d), cfg["l_max"], cfg["m_max"])
    with torch.no_grad():
        xe = layer.edge_block(dist_d, zs[:, None, :].expand(b, a, a),
                              zs[:, :, None].expand(b, a, a))
    s, c = (cfg["l_max"] + 1) ** 2, cfg["sphere_channels"]
    x = dict(x=torch.randn(b, a, s, c, generator=g) * 0.5, d=d * mask_d[..., None], xe=xe,
             g=torch.randn(b, a, s, c, generator=g), node_mask=real, pair_mask=mask_d > 0)
    out = {k: t.to(dev).contiguous() for k, t in x.items()}
    out["ws"] = [getattr(layer, n).detach().to(dev).contiguous()
                 for n in layer.weight_names(cfg["m_max"])]
    out["dims"] = dict(l_max=cfg["l_max"], m_max=cfg["m_max"], n_grid=layer.grid_points)
    return out


def eqv2_kernel_inputs(dev, b: int, a: int, seed: int = SEED, drop: bool = True, **kw) -> dict:
    """Seeded inputs of kernels O and P, built as EquiformerV2 builds them
    (widths of configs/equiformer_v2.yaml unless `kw` shrinks them): each
    molecule has a/2..a real atoms (the rest padding, z = 0) of H C N O at
    random positions (Å, ~10 Å across); idx, d, xe and maskf from a seeded
    one-block model's `edge_inputs` over the 12 Å / 30-neighbour graph, that
    block's attention weights `ws` in the kernel's layout; x and the
    cotangent g random; dropk a seeded keep mask (p 0.1, pre-scaled by
    1/0.9) or, with drop=False, ones. Also `ones` (eval mode's dropk) and
    node_mask."""
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import seeded_generator

    cfg = dict(EQV2_KW, num_layers=1, **kw)
    g = torch.Generator().manual_seed(seed)
    n_atoms = torch.randint(max(a // 2, 1), a + 1, (b,), generator=g)
    real = torch.arange(a)[None] < n_atoms[:, None]
    zs = torch.tensor([1, 6, 7, 8])[torch.randint(0, 4, (b, a), generator=g)] * real
    pos = torch.randn(b, a, 3, generator=g) * 2.5 * real[..., None]
    model = create_model("equiformer_v2", device="cpu", generator=seeded_generator(seed),
                         use_pallas="fused", **cfg)
    ga = model.block_0.ga
    with torch.no_grad():
        ctx = model.edge_inputs(pos, real, zs)
        ws = [w.detach() for w in ga.kernel_weights()]
    s, c = (cfg["l_max"] + 1) ** 2, cfg["sphere_channels"]
    nh, co = cfg["num_heads"], cfg["num_heads"] * cfg["attn_value_channels"]
    keep = torch.rand(*ctx["maskf"].shape, nh, generator=g) >= 0.1
    x = dict(x=torch.randn(b, a, s, c, generator=g) * 0.5, idx=ctx["idx"], d=ctx["d"],
             xe=ctx["xe"], maskf=ctx["maskf"],
             dropk=keep.float() / 0.9 if drop else ctx["ones"], ones=ctx["ones"],
             g=torch.randn(b, a, s, co, generator=g), node_mask=real)
    out = {k: t.to(dev).contiguous() for k, t in x.items()}
    out["ws"] = [w.to(dev).contiguous() for w in ws]
    out["dims"] = ga.kernel_dims()
    return out


def stage_times(fn, args) -> dict:
    """{kernel name: device ms} of one call of `fn` (torch.profiler): where a
    kernel built of several launches spends its time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = _kernel_name(e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _kernel_name(key: str) -> str:
    return re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", key)[:60]


# the steps of kernels O and P, read from their launches in order: a kernel named here
# is (its own step, the step of the unnamed launches after it: the engine's prep,
# products, weight gradients, reductions and column sums)
EQV2_STEPS = {
    "eqv2_flags_kernel": ("live list", "live list"),
    "so2_count_kernel": ("live list", "live list"),
    "so2_starts_kernel": ("live list", "live list"),
    "so2_list_kernel": ("live list", "radial product"),
    "eqv2_rows16_kernel": ("radial product", "radial product"),
    "eqv2_rotate_kernel": ("rotations", "conv 1"),
    "eqv2_grid_kernel": ("grid activation", "conv 2"),
    "eqv2_attn_out_kernel": ("attention head", "attention head"),
    "eqv2_attn_bwd_kernel": ("attention head", "conv 2"),
    "eqv2_grid_bwd_kernel": ("grid activation", "conv 1"),
    "eqv2_rot_bwd_kernel": ("rotations", "radial product"),
    "eqv2_sender_list_kernel": ("gx", "gx"),
    "eqv2_gx_kernel": ("gx", "gx"),
}


def step_times(fn, args, steps: dict) -> dict:
    """{step: device ms} of one call of `fn` (torch.profiler): its launches in
    the order they ran, a kernel named in `steps` counted to its own step and
    every other one to the step its last named predecessor gives ("setup"
    before the first: the wrapper's allocations)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    out, after = {}, "setup"
    for e in evs:
        name = _kernel_name(e.name)
        base = re.sub(r"<.*$", "", name)
        own, nxt = steps.get(base, (after, after))
        out[own] = out.get(own, 0.0) + e.time_range.elapsed_us() / 1e3
        after = nxt
    return out


def qhnet_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels I-L at the QHNet train path's shapes (B=QH_BATCH, A in
    BUCKETS, C=128, LMAX 4, H1/H2 32/32 for the conv and 8/128 for the
    pair) against their plain versions: errors (checked), kernel / plain /
    bound times; each runs twice for the same bits, and its line carries the
    device ms of each kernel its launch runs (`stages_ms`). The bounds
    count the live pairs' work (`qt.flops_bytes`): `bound_ms` with the gate
    products at the 3xTF32 tensor-core rate, `bound_fma_ms` all at the fp32
    FMA rate.
    The kernels line's numbers as in kernel_phases; each row carries the
    source's registers, spills and shared memory (ptxas)."""
    from nabladft_tpu_torch.ops import qhnet_tp as qt

    fns = {"I": (qt.qhnet_conv_fwd, qt.conv_fwd_reference, "cgsh", "c"),
           "J": (qt.qhnet_conv_bwd, qt.conv_bwd_reference, "cgsh", "c"),
           "K": (qt.qhnet_pair_fwd, qt.pair_fwd_reference, "zi", "p"),
           "L": (qt.qhnet_pair_bwd, qt.pair_bwd_reference, "zi", "p")}
    per = {k: [] for k in QHNET_KERNELS}
    for a in BUCKETS:
        x = qhnet_kernel_inputs(dev, QH_BATCH, a, QH_C, seed=SEED + 2000 + a)
        shape = [QH_BATCH, a, QH_C]
        for k, (fn, ref, table, tag) in fns.items():
            args = [x[n] for n in QH_ARGS[k]]
            as_tuple = (lambda t: t if isinstance(t, tuple) else (t,))
            got = as_tuple(fn(*args))
            err = compare(got, as_tuple(ref(*args)))
            check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel {k} error at {shape}: {err}")
            again = as_tuple(fn(*args))
            check(all(torch.equal(p, q) for p, q in zip(got, again)),
                  f"kernel {k} deterministic at {shape}")
            extra = dict(bit_identical_rerun=True, stages_ms=stage_times(fn, args))
            del got, again
            torch.cuda.empty_cache()
            t_k = time_ms(lambda: fn(*args))
            t_p = time_ms(lambda: ref(*args), PLAIN_RUNS, 1)
            live = qt.live_pairs(k, x["cgsh"] if k in "IJ" else x["maskf"])
            work = qt.flops_bytes(k, x["x"], x[table], x[f"hr_{tag}"], x[f"hs_{tag}"], live)
            row = _so2_row(shape, err, t_k, t_p, work, card, flops_all_pairs=work["flops"],
                           live_pairs=live, pairs=work["pairs"], **extra)
            emit(f"kernel_{k}", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k,
                 plain_times=t_p)
            per[k].append(row)
        del x
        torch.cuda.empty_cache()
    rows = headline_rows(per, QHNET_KERNELS, "qhnet_tp", ())
    for k in rows:
        rows[k]["ptxas"] = ptxas.get("qhnet_tp", {})
    return rows


def orbital_rotation(zs, orbitals: dict, rot: torch.Tensor, o_max: int) -> torch.Tensor:
    """Block-diagonal Wigner-D over the orbital shells of one molecule."""
    from nabladft_tpu_torch.ops import so3

    ds = [d[0] for d in so3.wigner_d(rot[None].double(), 2)]
    t = torch.eye(o_max, dtype=torch.float64, device=rot.device)
    off = 0
    for z in zs:
        for l in orbitals[int(z)]:
            k = 2 * l + 1
            t[off:off + k, off:off + k] = ds[l]
            off += k
    return t


def qhnet_train_phase(tmp: Path) -> dict:
    """QHNet's train and test jobs (configs/qhnet.yaml at full width) on a
    seeded Hamiltonian DB, then the gradient, H and covariance checks per
    atom bucket and a profile of two train steps; returns the launch counts
    of the jobs."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.synthetic import write_random_hamiltonian_db

    db = write_random_hamiltonian_db(tmp / "hamiltonian.db", QH_MOLS, MIN_ATOMS, MAX_ATOMS,
                                     SEED)
    ckpt, outputs = tmp / "ckpt_qhnet", tmp / "outputs_qhnet"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config="qhnet")
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    dropped = dm.dataset.n_dropped
    filled = sorted({dm.dataset.bucket_shape(b)[0] for b in dm.dataset.bucket_of if b >= 0})
    check(filled == list(BUCKETS), f"every atom bucket holds molecules: {filled}")

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.time()
    res = pipelines.run(cfg)
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    test = pipelines.run(dict(cfg, job_type="test", ckpt_path=str(ckpt / best)))
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    steps, n_layers = res["step"], cfg["model"]["kwargs"]["num_layers"]
    # Self / Pair heads on the layers after start_layer
    n_pair = n_layers - 1 - cfg["model"]["kwargs"].get("start_layer", 2)
    evals = TRAIN_EPOCHS * n_val + n_test
    check(steps == TRAIN_EPOCHS * n_train, f"{steps} train steps, expected {TRAIN_EPOCHS} x {n_train}")
    # remat: the backward pass runs each Conv and Pair layer's forward again
    want = dict.fromkeys(launches, 0)  # the other families' kernels: none
    want.update({"qhnet_conv_fwd": 2 * n_layers * steps + n_layers * evals,
                 "qhnet_conv_bwd": n_layers * steps,
                 "qhnet_pair_fwd": 2 * n_pair * steps + n_pair * evals,
                 "qhnet_pair_bwd": n_pair * steps})
    check(launches == want, f"qhnet train/test launches {launches}, expected {want}")
    check((ckpt / "last.ckpt").exists() and (ckpt / best).exists(), "checkpoint files")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    check(len(step_rows) == steps and len(val_rows) == TRAIN_EPOCHS, "a CSV row per step and epoch")
    for r in step_rows:
        check(all(np.isfinite(r[k]) for k in ("train/total", "train/hamiltonian", "grad_norm")),
              f"finite train metrics {r}")
        check(r["skipped_nonfinite"] == 0.0, f"no skipped step {r}")
    for m in [res, test] + val_rows:
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check({"val/loss", "val/hamiltonian/mae"} <= set(res), f"val metrics {res}")
    check({"test/loss", "test/hamiltonian/mae"} <= set(test), f"test metrics {test}")
    rates = sorted(r["mols_per_sec"] for r in step_rows if r["epoch"] == TRAIN_EPOCHS - 1)
    epoch_ends = [t_start] + [r["time"] for r in val_rows]
    epoch_seconds = [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]

    checks = qhnet_model_checks(cfg, dm)
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None),
                                      torch.device("cuda"))
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    reset_all_launches()  # each I-L launch runs the engine's products twice
    profile_steps("qhnet_train_profile", trainer._train_step, batches, top=24,
                  present=("so2_mma_kernel", "so2_mmw_kernel", "qhnet_conv_tp_fwd_kernel",
                           "qhnet_pair_tp_fwd_kernel", "qhnet_conv_tp_bwd_kernel",
                           "qhnet_pair_gx_kernel", "qhnet_pair_tp_bwd_kernel"),
                  absent=("qhnet_gemm_nt_kernel", "qhnet_gw_kernel", "qhnet_conv_fwd_kernel",
                          "qhnet_pair_fwd_kernel"),
                  calls=lambda: {"so2_mma_kernel": 2 * sum(
                      n for k, n in all_launches().items() if k.startswith("qhnet_"))})
    emit("qhnet_train", config="qhnet", molecules=QH_MOLS, dropped_molecules=dropped,
         steps=steps, batches_per_epoch=n_train, val_batches=n_val, test_batches=n_test,
         launches=launches, expected_launches=want, final_val=res, test=test,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         grad_norm_max=max(r["grad_norm"] for r in step_rows),
         molecules_per_second={"median": rates[len(rates) // 2], "min": rates[0],
                               "max": rates[-1], "steps": rates, "epoch": TRAIN_EPOCHS - 1},
         seconds_per_epoch=epoch_seconds, peak_device_memory_bytes=peak_mem,
         model_checks=checks,
         tolerances={"grad_rel": QH_GRAD_RTOL, "h_rel": QH_H_RTOL, "covariance_rel": QH_COV_RTOL})
    return launches


def qhnet_model_checks(cfg: dict, dm) -> list:
    """For the first train batch of each atom bucket, on the card with the
    same seeded weights: the kernel path's (I-L) parameter gradients and H
    against the plain module's (use_pallas "off"), and the kernel path's H
    of the batch rotated against T(R) H T(R)^T."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.train import Trainer, TrainerConfig

    dev = torch.device("cuda")
    t = dict(cfg["trainer"], loss_specs=cfg["model"]["loss_specs"],
             loss_coefs=cfg["model"]["loss_coefs"])
    plain_cfg = dict(cfg, model=dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"],
                                                               use_pallas="off")))
    fused = Trainer(pipelines.build_model(cfg, dev), dev, TrainerConfig(**t))
    plain = Trainer(pipelines.build_model(plain_cfg, dev), dev, TrainerConfig(**t))
    check(fused.model.use_pallas == "fused" and plain.model.use_pallas == "off", "model modes")
    orbitals = fused.model.layout.orbitals
    rot = torch.from_numpy(rotation()).to(dev)
    first = {}
    for batch in dm.train_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    out = []
    for a, batch in sorted(first.items()):
        batch = batch.to(dev)
        lf, lp = fused._compute_grads(batch), plain._compute_grads(batch)
        err = _grad_errs(fused.model, plain.model)
        worst_name = max(err, key=err.get)
        worst = err[worst_name]
        check(worst <= QH_GRAD_RTOL, f"gradient check at A={a}: {worst_name} off by {worst:.3e}")
        with torch.no_grad():
            h_f = fused.model(batch)["hamiltonian"]
            h_p = plain.model(batch)["hamiltonian"]
            h_r = fused.model(batch.replace(pos=batch.pos @ rot.T))["hamiltonian"]
        h_scale = float(h_p.abs().max())
        h_err = float((h_f - h_p).abs().max())
        check(h_err <= QH_H_RTOL * h_scale, f"H at A={a}: {h_err} vs max |H| {h_scale}")
        cov = 0.0
        for k in range(batch.z.shape[0]):
            if not bool(batch.graph_mask[k]):
                continue
            zs = batch.z[k][batch.node_mask[k]].tolist()
            tr = orbital_rotation(zs, orbitals, rot, h_f.shape[-1])
            want = tr @ h_f[k].double() @ tr.T
            cov = max(cov, float((h_r[k].double() - want).abs().max()))
        check(cov <= QH_COV_RTOL * h_scale, f"covariance at A={a}: {cov} vs max |H| {h_scale}")
        out.append({"shape": list(batch.z.shape), "orbitals": batch.orb_mask.shape[1],
                    "max_rel_grad_err": worst, "worst_param": worst_name,
                    "loss_kernel": float(lf["total"]), "loss_plain": float(lp["total"]),
                    "max_abs_h_err": h_err, "max_abs_h": h_scale,
                    "max_abs_covariance_err": cov})
    check(sorted(first) == list(BUCKETS), f"model check buckets {sorted(first)}")
    return out


ESCN_KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/escn_layer.py)
    "M": ("escn_fwd (M)", 385), "N": ("escn_bwd (N)", 398),
}
# the plain versions of M and N, and the plain module on the card, run
# ESCN_PLAIN_MOLS molecules at a time: their autograd and einsum intermediates
# grow with B·A². Molecules are independent, so the chunks' per-molecule
# outputs concatenate and N's weight gradients sum.
ESCN_PLAIN_MOLS = 16
# eSCN on the card, fused against plain: E and F within ESCN_OUT_RTOL x the
# output's largest magnitude (at random weights the forces are ~1e-5, the
# residue of sphere samples that nearly cancel, below any absolute
# tolerance); parameter gradients within ESCN_GRAD_RTOL x max |g| per tensor,
# each fp32 path's distance from the plain module in float64 printed beside
# it (that cancellation moves the force head's bias gradients by fp32
# rounding alone). Under a rotation E stays within ESCN_OUT_RTOL x max |E|; F
# co-rotates only up to the truncated grid's aliasing (2M+1 longitudes in
# each edge's frame), a property of the model: the fused and plain modules'
# forces on the rotated batch are held to each other, and their equivariance
# errors are printed.
ESCN_OUT_RTOL, ESCN_GRAD_RTOL = 1e-4, 1e-3
# molecules of each bucket's first batch held against the CPU plain path
# (eight full-width layers on the host's cores), and in the gradient check
# (the plain module's autograd in float64)
ESCN_CPU_MOLS = 2


def _plain_in_chunks(ref, args, n_mol: int, kw: dict, n: int):
    """A plain kernel version over the batch, n molecules at a time: args'
    first n_mol inputs (and kw's cotangent g) are per molecule, the rest
    (the weights) shared. A forward's output is concatenated; a backward's
    cotangents with a batch axis (M/N's gx, gxe; O/P's gx, gxi, gxe)
    concatenated and its weight gradients summed in chunk order."""
    kw = dict(kw)
    g = kw.pop("g", None)
    parts = []
    for i in range(0, args[0].shape[0], n):
        sl = slice(i, i + n)
        parts.append(ref(*[a[sl] for a in args[:n_mol]], *args[n_mol:], **kw,
                         **({} if g is None else {"g": g[sl]})))
    if g is None:
        return torch.cat(parts)
    n_cat = len(parts[0]) - (len(args) - n_mol)  # the cotangents with a batch axis
    out = [torch.cat([q[k] for q in parts]) for k in range(n_cat)]
    for k in range(n_cat, len(parts[0])):
        acc = parts[0][k].clone()
        for q in parts[1:]:
            acc += q[k]
        out.append(acc)
    return tuple(out)


def escn_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels M and N at every shape the eSCN paths give them (B=BATCH, A in
    BUCKETS, escn-oc widths), on eSCN-built inputs, against their plain
    versions (run ESCN_PLAIN_MOLS molecules at a time, timed over the whole
    batch): errors (checked), kernel / plain / bound times; N twice for the
    same bits. The bound counts the FLOP model's work of the live pairs (the
    kernels skip the rest): `bound_ms` with the products at the 3xTF32
    tensor-core rate, `bound_fma_ms` all at the fp32 FMA rate (`tc_bound`);
    `flops_all_pairs` is the model over all B·A² pairs. Each row carries
    the kernels' registers, spills and shared memory (ptxas)."""
    from nabladft_tpu_torch.ops import escn_layer as el

    fns = {"M": (el.escn_fwd, el.escn_fwd_reference), "N": (el.escn_bwd, el.escn_bwd_reference)}
    per = {k: [] for k in ESCN_KERNELS}
    for a in BUCKETS:
        x = escn_kernel_inputs(dev, BATCH, a, seed=SEED + 3000 + a)
        args, dims = (x["x"], x["d"], x["xe"], *x["ws"]), x["dims"]
        shape = [BATCH, a, ESCN_KW["sphere_channels"]]
        live = el.live_pairs(x["d"])
        for k, (fn, ref) in fns.items():
            kw = dict(dims, g=x["g"]) if k == "N" else dims
            as_tuple = (lambda t: t if isinstance(t, tuple) else (t,))
            plain = (lambda ref=ref, kw=kw: _plain_in_chunks(ref, args, 3, kw, ESCN_PLAIN_MOLS))
            got = as_tuple(fn(*args, **kw))
            err = compare(got, as_tuple(plain()))
            check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel {k} error at {shape}: {err}")
            extra = {"live_pairs": live, "pairs": BATCH * a * a,
                     "plain_molecules_per_call": ESCN_PLAIN_MOLS}
            if k == "N":
                again = as_tuple(fn(*args, **kw))
                check(all(torch.equal(p, q) for p, q in zip(got, again)),
                      f"kernel N deterministic at {shape}")
                extra["bit_identical_rerun"] = True
                del again
            del got
            torch.cuda.empty_cache()
            t_k = time_ms(lambda: fn(*args, **kw))
            t_p = time_ms(plain, PLAIN_RUNS, 1)
            work = el.flops_bytes(k, x["x"], x["d"], x["xe"], x["ws"], **dims)
            row = _so2_row(shape, err, t_k, t_p, work, card, flops_all_pairs=work["flops"],
                           **extra)
            emit(f"kernel_{k}", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k,
                 plain_times=t_p)
            per[k].append(row)
        del x, args
        torch.cuda.empty_cache()
    rows = headline_rows(per, ESCN_KERNELS, "escn_layer", ())
    for k in rows:
        rows[k]["ptxas"] = ptxas.get("escn_layer", {})
    return rows


def _mols(batch, sl: slice):
    """The molecules `sl` of a batch (every field's leading axis)."""
    import dataclasses

    return batch.replace(**{f.name: getattr(batch, f.name)[sl] for f in dataclasses.fields(batch)
                            if getattr(batch, f.name) is not None})


def _forward_in_chunks(model, batch, n: int) -> dict:
    """`forward` of the model over the batch, n molecules at a time."""
    from nabladft_tpu_torch.models.base import forward

    outs = [forward(model, _mols(batch, slice(i, i + n))) for i in range(0, batch.z.shape[0], n)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


EQV2_KERNELS = {  # key: (name, JAX kernel body line in nabladft_tpu/ops/pallas/eqv2_attn.py)
    "O": ("eqv2_fwd (O)", 640), "P": ("eqv2_bwd (P)", 741),
}
EQV2_ARGS = ("x", "x", "idx", "d", "xe", "maskf", "dropk")
# the plain versions of O and P, and the plain module on the card, run
# EQV2_PLAIN_MOLS molecules at a time (their autograd and einsum
# intermediates grow with the B·A·K edge slots); the chunks' per-molecule
# outputs concatenate and P's weight gradients sum
EQV2_PLAIN_MOLS = 16
# EquiformerV2 on the card, fused against plain: E and F within
# EQV2_OUT_RTOL x the output's largest magnitude, parameter gradients within
# EQV2_GRAD_RTOL x max |g| per tensor (each fp32 path's distance from the
# plain module in float64 printed beside it). Under a rotation E and F move
# by the per-edge truncated grid's aliasing (2M+1 longitudes in each edge's
# frame), the model's own: the plain module and JAX's XLA model move E by
# ~5e-3 of max |E| at full width, so E is held within EQV2_E_ROT x max |E|,
# the fused and plain modules' outputs on the rotated batch to each other
# within EQV2_OUT_RTOL, and F's equivariance error is printed.
EQV2_OUT_RTOL, EQV2_GRAD_RTOL, EQV2_E_ROT = 1e-4, 1e-3, 2e-2
# molecules of each bucket's first batch held against the CPU plain path (13
# full-width attention calls on the host's cores), and in the gradient
# check (the plain autograd in float64)
EQV2_CPU_MOLS, EQV2_GRAD_MOLS = 1, 2
# timed passes of eSCN's and EquiformerV2's predict loops after a warm-up pass
# (cut from PASSES: a pass over the 256 molecules takes one to three seconds)
ESCN_PASSES, EQV2_PASSES = 2, 2


def _eqv2_args(inp, **over):
    """Kernel O / P's positional arguments, `over` replacing inputs."""
    t = dict(inp, **over)
    return [t[k] for k in EQV2_ARGS] + t["ws"]


def so2_products_phase(dev, card: str, inp: dict, rows: int) -> None:
    """The product engine alone on P's largest product: conv 1's m=0 rows
    [rows, 1792] (seeded, ~N(0, 0.5²)) times the block's w1 [1792, 1536],
    over `rows` = the live edges; its error against float64, its time beside
    one fp32 torch.matmul of the same rows (library_ms, TF32 off), the
    achieved TFLOP/s and the fp32 FMA and 3xTF32 tensor-core bounds. Then
    the bf16 row (`bf16`): the engine's bf16 operand mode on the same rows as
    bf16 values (w1 rounded in its prep) against float64 of the rounded
    operands, beside one bf16 torch.matmul of the same bf16 operands (fp32
    accumulation, main() turns off the reduced-precision reduction; its
    output bf16) and the dense bf16 tensor-core bound."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea
    from nabladft_tpu_torch.ops.escn_layer import round_bf16

    peak_flops, peak_bw, peak_tf32 = peaks(card, tensor_cores=True)
    w = inp["ws"][2]
    k, n = w.shape
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(rows, k, generator=g, device=dev) * 0.5
    c = torch.empty(rows, n, device=dev)
    probs = [dict(segs=[dict(a=a, b=w, k=k)], n=n, c=c)]
    ea.so2_products(probs, rows)
    ref = a.double() @ w.double()
    err = compare((c,), (ref,))
    check(err["max_rel_err"] <= KERNEL_RTOL, f"so2_products error: {err}")
    del ref
    t_k = time_ms(lambda: ea.so2_products(probs, rows))
    t_l = time_ms(lambda: torch.matmul(a, w))
    flops, nbytes = 2 * rows * k * n, 4 * (rows * k + k * n + rows * n)
    t_bytes = nbytes / peak_bw * 1e3

    a16, w16 = a.bfloat16(), w.bfloat16()
    probs16 = [dict(segs=[dict(a=a16, b=w, k=k, bf16=True)], n=n, c=c)]
    ea.so2_products(probs16, rows)
    ref = a16.double() @ round_bf16(w).double()
    err16 = compare((c,), (ref,))
    check(err16["max_rel_err"] <= KERNEL_RTOL, f"so2_products bf16 error: {err16}")
    del ref
    t_k16 = time_ms(lambda: ea.so2_products(probs16, rows))
    t_l16 = time_ms(lambda: torch.matmul(a16, w16))
    nbytes16 = 2 * (rows * k + k * n) + 4 * rows * n
    bf16 = dict(**err16, ms=t_k16["median"], library_ms=t_l16["median"],
                library="torch.matmul bf16 (fp32 accumulation, bf16 output)",
                tflops=flops / t_k16["median"] / 1e9,
                library_tflops=flops / t_l16["median"] / 1e9,
                bound_tc_ms=max(flops / bf16_peak(card) * 1e3, nbytes16 / peak_bw * 1e3),
                bytes=nbytes16, kernel_times=t_k16, library_times=t_l16)
    emit("so2_products", rows=rows, k=k, n=n, **err, tolerance_rel=KERNEL_RTOL,
         ms=t_k["median"], library_ms=t_l["median"], library="torch.matmul fp32 (TF32 off)",
         tflops=flops / t_k["median"] / 1e9, library_tflops=flops / t_l["median"] / 1e9,
         bound_tc_ms=max(flops / (peak_tf32 / TC_PASSES) * 1e3, t_bytes),
         bound_fma_ms=max(flops / peak_flops * 1e3, t_bytes), flops=flops, bytes=nbytes,
         kernel_times=t_k, library_times=t_l, bf16=bf16)
    del a, c, a16, w16
    torch.cuda.empty_cache()


def eqv2_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels O and P at every shape the EquiformerV2 paths give them
    (B=BATCH, A in BUCKETS, configs/equiformer_v2.yaml widths), on
    EquiformerV2-built inputs, against their plain versions (run
    EQV2_PLAIN_MOLS molecules at a time, timed over the whole batch): O with
    dropk ones (eval) and a seeded keep mask (train), P with the mask, every
    cotangent checked, twice for the same bits; kernel / plain / bound
    times. The bound counts the FLOP model's work of the live edges (the
    kernels skip the rest), as M and N's does; `flops_all_slots` is the
    model over all B·A·K edge slots. At A=HEADLINE_A also the engine alone
    on P's largest product (`so2_products_phase`)."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea

    per = {k: [] for k in EQV2_KERNELS}
    for a in BUCKETS:
        inp = eqv2_kernel_inputs(dev, BATCH, a, seed=SEED + 4000 + a, drop=True)
        shape = [BATCH, a, EQV2_KW["sphere_channels"]]
        live = ea.live_edges(inp["maskf"])
        extra = {"live_edges": live, "edge_slots": inp["maskf"].numel(),
                 "plain_molecules_per_call": EQV2_PLAIN_MOLS}
        args, dims = _eqv2_args(inp), inp["dims"]

        # O: dropk = ones (the eval paths) and the seeded keep mask (train)
        errs = {}
        for tag, over in (("ones", {"dropk": inp["ones"]}), ("mask", {})):
            a_tag = _eqv2_args(inp, **over)
            got = ea.eqv2_fwd(*a_tag, **dims)
            err = compare((got,), (_plain_in_chunks(ea.eqv2_fwd_reference, a_tag, 7, dims,
                                                     EQV2_PLAIN_MOLS),))
            check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel O ({tag}) error at {shape}: {err}")
            errs[tag] = err
            del got
        torch.cuda.empty_cache()
        t_k = time_ms(lambda: ea.eqv2_fwd(*args, **dims))
        t_p = time_ms(lambda: _plain_in_chunks(ea.eqv2_fwd_reference, args, 7, dims,
                                               EQV2_PLAIN_MOLS), PLAIN_RUNS, 1)
        work = ea.flops_bytes("O", inp["x"], inp["idx"], inp["d"], inp["xe"], inp["maskf"],
                              inp["dropk"], inp["ws"], **dims)
        row = _so2_row(shape, errs["mask"], t_k, t_p, work, card, flops_all_slots=work["flops"],
                       max_rel_err_dropk_ones=errs["ones"]["max_rel_err"],
                       max_rel_err_dropk_mask=errs["mask"]["max_rel_err"], **extra)
        row["max_abs_err"] = max(errs["ones"]["max_abs_err"], errs["mask"]["max_abs_err"])
        emit("kernel_O", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)
        per["O"].append(row)

        if a == HEADLINE_A:
            so2_products_phase(dev, card, inp, live)

        # P: every cotangent, run twice for the same bits
        got = ea.eqv2_bwd(*args, g=inp["g"], **dims)
        bwd_kw = dict(dims, g=inp["g"])
        err = compare(got, _plain_in_chunks(ea.eqv2_bwd_reference, args, 7, bwd_kw,
                                            EQV2_PLAIN_MOLS))
        # max_rel_err is the largest over the cotangents, each against its own scale
        check(err["max_rel_err"] <= KERNEL_RTOL, f"kernel P error at {shape}: {err}")
        again = ea.eqv2_bwd(*args, g=inp["g"], **dims)
        check(all(torch.equal(p, q) for p, q in zip(got, again)),
              f"kernel P deterministic at {shape}")
        del got, again
        torch.cuda.empty_cache()
        t_k = time_ms(lambda: ea.eqv2_bwd(*args, g=inp["g"], **dims))
        t_p = time_ms(lambda: _plain_in_chunks(ea.eqv2_bwd_reference, args, 7, bwd_kw,
                                               EQV2_PLAIN_MOLS), PLAIN_RUNS, 1)
        work = ea.flops_bytes("P", inp["x"], inp["idx"], inp["d"], inp["xe"], inp["maskf"],
                              inp["dropk"], inp["ws"], **dims)
        row = _so2_row(shape, err, t_k, t_p, work, card, flops_all_slots=work["flops"],
                       bit_identical_rerun=True,
                       cotangents=["gx", "gxi", "gxe"] + ea.weight_names(dims["m_max"]), **extra)
        emit("kernel_P", **row, tolerance_rel=KERNEL_RTOL, kernel_times=t_k, plain_times=t_p)
        per["P"].append(row)
        del inp, args
        torch.cuda.empty_cache()
    rows = headline_rows(per, EQV2_KERNELS, "eqv2_attn", ())
    for k in rows:
        rows[k]["ptxas"] = ptxas.get("eqv2_attn", {})
    return rows


# the direct-force SO(2) families chip_smoke drives: config, kernel counters
# (forward, backward), message / attention calls per forward, the plain
# module's and the CPU reference's molecules per call, the gradient check's
# molecules, tolerances (outputs, gradients, E under a rotation), timed
# predict passes, and whether the model draws dropout in training
DIRECT = {
    "escn": dict(config="escn-oc", fwd="escn_fwd", bwd="escn_bwd",
                 calls=lambda kw: kw["num_layers"], plain_mols=ESCN_PLAIN_MOLS,
                 cpu_mols=ESCN_CPU_MOLS, grad_mols=ESCN_CPU_MOLS, out_rtol=ESCN_OUT_RTOL,
                 grad_rtol=ESCN_GRAD_RTOL, e_rot=ESCN_OUT_RTOL, passes=ESCN_PASSES,
                 dropout=False),
    "eqv2": dict(config="equiformer_v2", fwd="eqv2_fwd", bwd="eqv2_bwd",
                 calls=lambda kw: kw["num_layers"] + 1, plain_mols=EQV2_PLAIN_MOLS,
                 cpu_mols=EQV2_CPU_MOLS, grad_mols=EQV2_GRAD_MOLS, out_rtol=EQV2_OUT_RTOL,
                 grad_rtol=EQV2_GRAD_RTOL, e_rot=EQV2_E_ROT, passes=EQV2_PASSES, dropout=True),
}


class DropoutDraws:
    """Counts the dropout masks drawn while it is entered (every mask is one
    `torch.rand` call): "alpha" ([B, A, K, NH], one per attention call) and
    "drop_path" ([B, 1, 1, 1], two per block)."""

    def __enter__(self):
        self.counts = {"alpha": 0, "drop_path": 0}
        self._rand = torch.rand

        def counting(size, *args, **kwargs):
            self.counts["drop_path" if tuple(size)[1:] == (1, 1, 1) else "alpha"] += 1
            return self._rand(size, *args, **kwargs)

        torch.rand = counting
        return self.counts

    def __exit__(self, *exc):
        torch.rand = self._rand


def _plain_cfg(cfg: dict) -> dict:
    return dict(cfg, model=dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"],
                                                          use_pallas="off")))


def direct_predict_phase(tmp: Path, db: Path, family: str) -> dict:
    """`job_type: predict` of a direct-force family (eSCN, EquiformerV2) at
    full width and depth, batch BATCH, over the seeded DB: rows, finite
    values, the forward kernel once per message / attention call of each
    batch, the backward never, no dropout drawn; per bucket, the first batch
    and the same batch rotated against the plain module on the card (eval
    mode, as the job runs the model), its first molecules against the CPU
    plain path; E under the rotation within the family's limit, F's
    equivariance error printed; molecules/s of the predict loop."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.models.base import forward
    from nabladft_tpu_torch.train import Trainer

    fam = DIRECT[family]
    cfg = smoke_config(str(db), str(tmp / f"predictions_{family}.db"), str(tmp),
                       config=fam["config"])
    n_calls = fam["calls"](cfg["model"]["kwargs"])

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    with DropoutDraws() as draws:
        res = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    n_batches = res["batches"]
    check(res["rows"] == N_MOLS, f"rows written {res['rows']} != {N_MOLS}")
    want = dict.fromkeys(launches, 0)
    want[fam["fwd"]] = n_calls * n_batches
    check(launches == want, f"{family} predict launches {launches}, expected {want}")
    check(draws == {"alpha": 0, "drop_path": 0}, f"dropout drawn on predict: {draws}")
    dm = pipelines.build_datamodule(cfg)
    # the writer keeps the loader's order of the real molecules
    order = [mid for b in dm.predict_dataloader()
             for mid, real in zip(b.mol_id.tolist(), b.graph_mask.tolist()) if real]
    out_rows = dict(zip(order, AseDatabase(cfg["output_db"]).select_all()))
    check(len(out_rows) == N_MOLS, "output DB row count")
    for rec in out_rows.values():
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(e.shape == (1,) and f.shape == (rec.natoms, 3), "prediction shapes")
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite predictions")

    shapes = sorted({tuple(b.z.shape) for b in dm.predict_dataloader()})
    check(all(s in [(BATCH, a) for a in BUCKETS] for s in shapes), f"predict batch shapes {shapes}")
    dev = torch.device("cuda")
    gpu = Trainer(pipelines.build_model(cfg, dev).eval(), dev)
    plain = Trainer(pipelines.build_model(_plain_cfg(cfg), dev).eval(), dev)
    cpu = Trainer(pipelines.build_model(cfg, torch.device("cpu")).eval(), "cpu")
    check(gpu.model.use_pallas == "fused" and plain.model.use_pallas == "off"
          and cpu.model.use_pallas == "off", "model modes")
    first = {}
    for batch in dm.predict_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    checks = []
    rot = torch.from_numpy(rotation()).to(dev)
    for a, batch in sorted(first.items()):
        bg = batch.to(dev)
        bg_r = bg.replace(pos=bg.pos @ rot.T)
        out_f, out_r = forward(gpu.model, bg), forward(gpu.model, bg_r)
        out_p = _forward_in_chunks(plain.model, bg, fam["plain_mols"])
        out_pr = _forward_in_chunks(plain.model, bg_r, fam["plain_mols"])
        first_c = slice(0, fam["cpu_mols"])
        out_c = forward(cpu.model, _mols(batch, first_c))
        m = bg.graph_mask.cpu().numpy()
        # the job's rows are the fused model's outputs of this batch
        for i, mol_id in enumerate(batch.mol_id.tolist()):
            if m[i]:
                rec = out_rows[mol_id]
                check(abs(rec.data["energy_pred"][0] - float(out_f["energy"][i])) <= 1e-6 *
                      max(abs(float(out_f["energy"][i])), 1e-6), "job rows = the fused model")
        scale = {"energy": _max_abs(out_p["energy"]), "forces": _max_abs(out_p["forces"])}
        row = {"shape": list(batch.z.shape), "max_abs_energy": scale["energy"],
               "max_abs_force": scale["forces"]}
        for tag, got, ref in (("card_plain", out_f, out_p), ("card_plain_rotated", out_r, out_pr),
                              ("cpu_plain", {k: v[first_c].cpu() for k, v in out_f.items()},
                               out_c)):
            for k in ("energy", "forces"):
                err = _max_abs(got[k] - ref[k].to(got[k].device))
                row[f"{k}_abs_err_vs_{tag}"] = err
                row[f"{k}_rel_err_vs_{tag}"] = err / scale[k]
                check(err <= fam["out_rtol"] * scale[k],
                      f"{family} {k} at A={a} vs {tag}: {err} > {fam['out_rtol']} x {scale[k]}")
        e_rot = _max_abs(out_r["energy"] - out_f["energy"])
        check(e_rot <= fam["e_rot"] * scale["energy"],
              f"{family} energy under a rotation at A={a}: {e_rot} vs max |E| {scale['energy']}")
        # readings: E's and F's rotation errors, the fused and the plain module's
        row["rotation_energy_rel_err"] = e_rot / scale["energy"]
        row["rotation_energy_rel_err_plain"] = (_max_abs(out_pr["energy"] - out_p["energy"])
                                                / scale["energy"])
        row["rotation_force_rel_err"] = (_max_abs(out_r["forces"] - out_f["forces"] @ rot.T)
                                         / scale["forces"])
        row["rotation_force_rel_err_plain"] = (_max_abs(out_pr["forces"] - out_p["forces"] @ rot.T)
                                               / scale["forces"])
        checks.append(row)
        del out_f, out_r, out_p, out_pr
    check(sorted(first) == list(BUCKETS), f"predict buckets {sorted(first)}")
    del plain, cpu
    torch.cuda.empty_cache()

    rates = []
    for p in range(fam["passes"] + 1):
        t0 = time.perf_counter()
        n_pred = sum(len(o["energy"]) for o in gpu.predict(dm.predict_dataloader()))
        torch.cuda.synchronize()
        if p:
            rates.append(n_pred / (time.perf_counter() - t0))
    rates.sort()
    busy = profile_phase(f"{family}_profile", gpu, dm)
    READINGS[f"{family}_predict"] = dict(molecules_per_second=rates[len(rates) // 2],
                                         device_busy_share=busy,
                                         peak_device_memory_bytes=peak_mem)
    emit(f"{family}_predict", config=fam["config"], rows=res["rows"], batches=n_batches,
         batch_shapes=shapes, launches=launches, dropout_draws=draws,
         run_seconds=res["seconds"], checks=checks,
         molecules_per_second={"median": rates[len(rates) // 2], "min": rates[0],
                               "max": rates[-1], "passes": rates},
         peak_device_memory_bytes=peak_mem,
         tolerances={"output_rel": fam["out_rtol"], "rotation_energy_rel": fam["e_rot"]})
    return launches


def direct_train_phase(tmp: Path, db: Path, family: str) -> dict:
    """The train (TRAIN_EPOCHS epochs) and test jobs of a direct-force family
    at full width and depth, batch BATCH: the forward kernel once per call
    of each train step, validation and test batch, the backward once per
    call of each train step; dropout drawn on train steps only
    (EquiformerV2: 13 alpha and 24 drop-path masks a step); finite losses
    and metrics; per bucket, dropout off, the fused model's parameter
    gradients against the plain module's on the card (checked) and both
    against the plain module in float64 (printed), on the first molecules
    (the plain autograd's memory); a profile of two train steps."""
    import copy

    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.train import Trainer, TrainerConfig

    fam = DIRECT[family]
    ckpt, outputs = tmp / f"ckpt_{family}", tmp / f"outputs_{family}"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config=fam["config"])
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    n_layers = cfg["model"]["kwargs"]["num_layers"]
    n_calls = fam["calls"](cfg["model"]["kwargs"])

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.time()
    with DropoutDraws() as draws:
        res = pipelines.run(cfg)
        draws_train = dict(draws)
        best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
        test = pipelines.run(dict(cfg, job_type="test", ckpt_path=str(ckpt / best)))
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()

    steps = res["step"]
    check(steps == TRAIN_EPOCHS * n_train,
          f"{steps} train steps, expected {TRAIN_EPOCHS} x {n_train}")
    want = dict.fromkeys(launches, 0)
    want.update({fam["fwd"]: n_calls * (steps + TRAIN_EPOCHS * n_val + n_test),
                 fam["bwd"]: n_calls * steps})
    check(launches == want, f"{family} train/test launches {launches}, expected {want}")
    want_draws = ({"alpha": n_calls * steps, "drop_path": 2 * n_layers * steps}
                  if fam["dropout"] else {"alpha": 0, "drop_path": 0})
    check(draws_train == draws == want_draws,
          f"dropout draws {draws_train} (train), {draws} (after test), expected {want_draws}")
    check((ckpt / "last.ckpt").exists() and (ckpt / best).exists(), "checkpoint files")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    check(len(step_rows) == steps and len(val_rows) == TRAIN_EPOCHS, "a CSV row per step and epoch")
    for r in step_rows:
        check(all(np.isfinite(r[k]) for k in ("train/total", "train/energy", "train/forces",
                                              "grad_norm")), f"finite train metrics {r}")
        check(r["skipped_nonfinite"] == 0.0, f"no skipped step {r}")
    for m in [res, test] + val_rows:
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check({"test/loss", "test/energy/mae", "test/forces/mae"} <= set(test), f"test metrics {test}")
    rates = sorted(r["mols_per_sec"] for r in step_rows if r["epoch"] == TRAIN_EPOCHS - 1)
    epoch_ends = [t_start] + [r["time"] for r in val_rows]
    epoch_seconds = [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]

    # fused against plain on the card, fp32 and float64, one batch per bucket,
    # dropout off in all three (eval mode)
    dev = torch.device("cuda")
    t = TrainerConfig(**dict(cfg["trainer"], loss_specs=cfg["model"]["loss_specs"],
                             loss_coefs=cfg["model"]["loss_coefs"]))
    fused = Trainer(pipelines.build_model(cfg, dev).eval(), dev, t)
    plain = Trainer(pipelines.build_model(_plain_cfg(cfg), dev).eval(), dev, t)
    exact = Trainer(copy.deepcopy(plain.model).double(), dev, t)
    check(fused.model.use_pallas == "fused" and plain.model.use_pallas == "off", "model modes")
    first = {}
    for batch in dm.train_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    grads = []
    for a, batch in sorted(first.items()):
        small = _mols(batch, slice(0, fam["grad_mols"])).to(dev)
        with DropoutDraws() as eval_draws:
            lf, lp = fused._compute_grads(small), plain._compute_grads(small)
            lx = exact._compute_grads(small.replace(**{k: getattr(small, k).double()
                                                       for k in ("pos", "energy", "forces")}))
        check(eval_draws == {"alpha": 0, "drop_path": 0}, "gradient check in eval")
        torch.cuda.empty_cache()
        err = _grad_errs(fused.model, plain.model)
        name = max(err, key=err.get)
        check(err[name] <= fam["grad_rtol"],
              f"gradient check at A={a}: {name} off by {err[name]:.3e}")
        check(abs(float(lf["total"]) - float(lp["total"])) <= 1e-4 * abs(float(lp["total"])),
              f"loss at A={a}: {float(lf['total'])} vs {float(lp['total'])}")
        # readings: each fp32 path against the float64 plain module
        err_f, err_p = _grad_errs(fused.model, exact.model), _grad_errs(plain.model, exact.model)
        grads.append({"shape": list(small.z.shape), "max_rel_grad_err": err[name],
                      "worst_param": name, "worst_param_fused_vs_float64": err_f[name],
                      "worst_param_plain_vs_float64": err_p[name],
                      "max_rel_grad_err_fused_vs_float64": max(err_f.values()),
                      "max_rel_grad_err_plain_vs_float64": max(err_p.values()),
                      "worst_params_vs_float64": [max(err_f, key=err_f.get),
                                                  max(err_p, key=err_p.get)],
                      "loss_kernel": float(lf["total"]), "loss_plain": float(lp["total"]),
                      "loss_float64": float(lx["total"])})
    check(sorted(first) == list(BUCKETS), f"gradient check buckets {sorted(first)}")
    del fused, plain, exact
    torch.cuda.empty_cache()

    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None), dev)
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    busy = profile_steps(f"{family}_train_profile", trainer._train_step, batches)
    READINGS[f"{family}_train"] = dict(molecules_per_second=rates[len(rates) // 2],
                                       device_busy_share=busy, peak_device_memory_bytes=peak_mem)
    # the masks come from the trainer's generator: its offset moves in a train
    # step and stays in validation
    gen = trainer._dropout_gen
    check((gen is not None) == fam["dropout"], f"{family} dropout generator {gen}")
    offsets = {}
    if gen is not None:
        offsets["train_steps"] = gen.get_offset()
        trainer.validate(itertools.islice(dm.val_dataloader(), 1))
        offsets["validation"] = gen.get_offset() - offsets["train_steps"]
        check(offsets["train_steps"] > 0 and offsets["validation"] == 0,
              f"dropout generator offsets {offsets}: drawn in train steps, not in validation")
    emit(f"{family}_train", config=fam["config"], steps=steps, batches_per_epoch=n_train,
         val_batches=n_val, test_batches=n_test, launches=launches, expected_launches=want,
         dropout_draws=draws, dropout_generator_offsets=offsets, final_val=res, test=test,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         grad_norm_max=max(r["grad_norm"] for r in step_rows),
         molecules_per_second={"median": rates[len(rates) // 2], "min": rates[0],
                               "max": rates[-1], "steps": rates, "epoch": TRAIN_EPOCHS - 1},
         seconds_per_epoch=epoch_seconds, peak_device_memory_bytes=peak_mem,
         gradient_check=grads, tolerances={"grad_rel": fam["grad_rtol"]})
    return launches


# PhiSNet's and the energy families' paths run no kernel of A-P
# (their JAX counterparts reach no pallas_call): torch's own GEMMs and
# elementwise kernels only. Their checks: PhiSNet's H, S and core on the
# card against the CPU (the same weights, PH_CPU_MOLS molecules per bucket)
# within QH_H_RTOL x max |matrix|, under a rotation within QH_COV_RTOL x max
# |matrix|, S of the other atoms under one atom's species change within
# PH_ENV_RTOL x max |S|; the energy families' E and F on the card against the
# CPU (ENERGY_CPU_MOLS per bucket) and under a rotation: each molecule's E
# within E_TOL's atol + rtol x its own |E| plus E_ULPS float32 ulps of the
# larger of |E| and the extensive offset |energy_mean| x n_atoms (DimeNet++
# adds that offset in float32, so a molecule whose network part cancels it
# keeps the sum's rounding, a few ulps of the offset), F within
# F_TOL's atol + rtol x the batch's largest |F|.
PH_CPU_MOLS, PH_ENV_RTOL = 1, 1e-6
E_ULPS = 8
ENERGY_CPU_MOLS, ENERGY_PASSES = 2, 2
# Graphormer3D's direct force head (the reference's NodeTaskHead) reads
# each Cartesian component out with a linear layer and bias of its own, so
# its F is not covariant under a rotation by design: the error is printed
ENERGY = {
    "dimenetpp": dict(config="dimenetplusplus", batch=DIMENETPP_BATCH, dropout=False,
                      f_covariant=True),
    "graphormer3d": dict(config="graphormer3d", batch=BATCH, dropout=True, f_covariant=False),
    "gemnet_oc": dict(config="gemnet-oc", batch=BATCH, dropout=False, f_covariant=True),
}
# GemNet-OC's scale factors: the card's fit against the CPU's (fp32 sums in
# another order, through a square root); its two triplet paths on the card,
# the tolerance of tests/models/test_gemnet_factored.py
GEMNET_FIT_RTOL = 1e-4
# the CPU fits the first molecules of the smallest fit batch: its fit of a
# whole full-width batch would take most of the script's time
GEMNET_CPU_FIT_MOLS = 8
GEMNET_PATHS_TOL = dict(rtol=2e-4, atol=2e-5)


def gemnet_scale_checks(cfg: dict, dm, trainer, ckpt: Path) -> dict:
    """GemNet-OC's scale factors after the train job: every checkpoint
    holds the same values, which a refit on the card of the batches the job
    fitted from (the first scale_fit_batches of the train loader's first
    pass) gives within 1e-6; the card's fit of the first GEMNET_CPU_FIT_MOLS
    molecules of the smallest of those batches against the CPU's within
    GEMNET_FIT_RTOL. Then loads the last
    checkpoint into `trainer`, whose profiled train steps must leave the
    fitted scales as they are."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.models.gemnet_oc import fit_scale_factors

    dev = torch.device("cuda")
    names = sorted(trainer.scales)
    saved = {p.name: torch.load(p, map_location="cpu", weights_only=True)["model"]
             for p in sorted(ckpt.glob("*.ckpt"))}
    batches = list(itertools.islice(dm.train_dataloader(), trainer.cfg.scale_fit_batches))
    refit = fit_scale_factors(pipelines.build_model(cfg, dev), batches).scale_factors()
    fitted = {n: refit[n].item() for n in names}
    for path, state in saved.items():
        for n in names:
            check(state[n].item() == next(iter(saved.values()))[n].item(),
                  f"scale {n} differs between checkpoints")
            check(abs(state[n].item() - fitted[n]) <= 1e-6 * abs(fitted[n]),
                  f"scale {n} in {path}: {state[n].item()} vs the refit {fitted[n]}")
    check(min(abs(v - 1.0) for v in fitted.values()) > 0.0, "every scale was fitted")
    one = [_mols(min(batches, key=lambda b: b.z.shape[1]), slice(0, GEMNET_CPU_FIT_MOLS))]
    card = fit_scale_factors(pipelines.build_model(cfg, dev), one).scale_factors()
    t0 = time.perf_counter()
    cpu = fit_scale_factors(pipelines.build_model(cfg, torch.device("cpu")), one).scale_factors()
    cpu_seconds = time.perf_counter() - t0
    rel = {n: abs(card[n].item() / cpu[n].item() - 1.0) for n in names}
    check(max(rel.values()) <= GEMNET_FIT_RTOL,
          f"scale fit on the card vs the CPU: {max(rel.values())} > {GEMNET_FIT_RTOL}")
    trainer.load_checkpoint(ckpt / "last.ckpt")
    return {"n_scales": len(names), "fit_batches": [list(b.z.shape) for b in batches],
            "checkpoints": sorted(saved), "fitted": fitted,
            "card_vs_cpu_max_rel": max(rel.values()), "cpu_fit_batch": list(one[0].z.shape),
            "cpu_fit_seconds": cpu_seconds}


def gemnet_paths(model, batch) -> dict:
    """The fitting path (explicit triplet lattice) against the factorised
    path on one batch on the card, within GEMNET_PATHS_TOL."""
    with torch.no_grad():
        fac, exp = model(batch), model(batch, stats={})
    row = {}
    for k in ("energy", "forces"):
        diff = (fac[k] - exp[k]).abs()
        limit = GEMNET_PATHS_TOL["atol"] + GEMNET_PATHS_TOL["rtol"] * exp[k].abs()
        row[f"{k}_paths_abs_err"] = _max_abs(diff)
        row[f"{k}_paths_err_over_limit"] = float((diff / limit).max())
        check(row[f"{k}_paths_err_over_limit"] <= 1.0,
              f"gemnet_oc triplet paths {k}: {row[f'{k}_paths_abs_err']}")
    return row


def _energy_limit(want: torch.Tensor, n_atoms: torch.Tensor, energy_mean: float) -> torch.Tensor:
    """Each molecule's limit on |E - want| (see E_ULPS)."""
    scale = torch.maximum(want.abs(), abs(energy_mean) * n_atoms.to(want))
    return (E_TOL["atol"] + E_TOL["rtol"] * want.abs()
            + E_ULPS * torch.finfo(torch.float32).eps * scale)


def _train_job(cfg: dict, ckpt: Path) -> tuple:
    """The main path of a train phase: `job_type: train`, then `test` from
    the best checkpoint, with every launch count reset just before and
    read just after. Returns (train result, test result, launches, peak
    memory, start time, best checkpoint)."""
    from nabladft_tpu_torch import pipelines

    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.time()
    res = pipelines.run(cfg)
    best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    test = pipelines.run(dict(cfg, job_type="test", ckpt_path=str(ckpt / best)))
    torch.cuda.synchronize()
    return (res, test, all_launches(), torch.cuda.max_memory_allocated(), t_start,
            ckpt / best)


def _train_readings(cfg: dict, res: dict, test: dict, targets, t_start: float, n_train: int,
                    epochs: int = TRAIN_EPOCHS):
    """The CSV's checks and readings of a train phase of `epochs` epochs: a
    row per step and epoch, finite metrics, no skipped step; (step rows,
    mol/s of the last epoch's steps sorted, seconds per epoch)."""
    rows = read_csv(Path(cfg["output_dir"]) / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    steps = res["step"]
    check(steps == epochs * n_train, f"{steps} train steps, expected {epochs} x {n_train}")
    check(len(step_rows) == steps and len(val_rows) == epochs, "a CSV row per step and epoch")
    for r in step_rows:
        check(all(np.isfinite(r[k]) for k in ["train/total", "grad_norm"]
                  + [f"train/{t}" for t in targets]), f"finite train metrics {r}")
        check(r["skipped_nonfinite"] == 0.0, f"no skipped step {r}")
    for m in [res, test] + val_rows:
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    for prefix, m in (("val", res), ("test", test)):
        want = {f"{prefix}/loss"} | {f"{prefix}/{t}/mae" for t in targets}
        check(want <= set(m), f"{prefix} metrics {m}")
    rates = sorted(r["mols_per_sec"] for r in step_rows if r["epoch"] == epochs - 1)
    epoch_ends = [t_start] + [r["time"] for r in val_rows]
    return step_rows, rates, [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]


def _rates(rates: list, what: str) -> dict:
    return {"median": rates[len(rates) // 2], "min": rates[0], "max": rates[-1], what: rates}


def phisnet_train_phase(tmp: Path) -> dict:
    """PhiSNet's train and test jobs (configs/phisnet.yaml at full width,
    loss H + S) over the Hamiltonian DB of QHNet's phase, then the model
    checks per atom bucket on the best checkpoint's weights and a profile of
    two train steps; returns the launch counts of the jobs (all zero)."""
    from nabladft_tpu_torch import pipelines

    db = tmp / "hamiltonian.db"  # written by qhnet_train_phase
    ckpt, outputs = tmp / "ckpt_phisnet", tmp / "outputs_phisnet"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config="phisnet")
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    res, test, launches, peak_mem, t_start, best = _train_job(cfg, ckpt)
    check(not any(launches.values()), f"phisnet train/test launched kernels of A-P: {launches}")
    check((ckpt / "last.ckpt").exists() and best.exists(), "checkpoint files")
    step_rows, rates, epoch_seconds = _train_readings(
        cfg, res, test, ("hamiltonian", "overlap"), t_start, n_train)

    dev = torch.device("cuda")
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None), dev)
    check(trainer.cfg.loss_specs == PHISNET_LOSS_SPECS,
          f"phisnet trains on {trainer.cfg.loss_specs}, expected H and S")
    trainer.load_checkpoint(best)
    checks = phisnet_model_checks(trainer.model, dm)
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    profile_steps("phisnet_train_profile", trainer._train_step, batches)
    emit("phisnet_train", config="phisnet", steps=res["step"], batches_per_epoch=n_train,
         val_batches=n_val, test_batches=n_test, launches=launches, final_val=res, test=test,
         loss_specs=trainer.cfg.loss_specs,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         grad_norm_max=max(r["grad_norm"] for r in step_rows),
         molecules_per_second=dict(_rates(rates, "steps"), epoch=TRAIN_EPOCHS - 1),
         seconds_per_epoch=epoch_seconds, peak_device_memory_bytes=peak_mem,
         model_checks=checks,
         tolerances={"cpu_rel": QH_H_RTOL, "covariance_rel": QH_COV_RTOL,
                     "overlap_environment_rel": PH_ENV_RTOL})
    return launches


def phisnet_model_checks(model, dm) -> list:
    """For the first train batch of each atom bucket, the trained model in
    eval mode: H, S and core exactly symmetric; the first
    PH_CPU_MOLS molecules against the same weights on the CPU; every real
    molecule's matrices under a rotation against T(R) M T(R)^T; S among the
    other atoms when one heavy atom becomes another element of the same
    orbital layout (C <-> N)."""
    import copy

    model.eval()
    cpu = copy.deepcopy(model).cpu()
    orbitals = model.layout.orbitals
    norb = {z: sum(2 * l + 1 for l in o) for z, o in orbitals.items()}
    dev = next(model.parameters()).device
    rot = torch.from_numpy(rotation()).to(dev)
    names = model.matrix_names
    first = {}
    for batch in dm.train_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    out = []
    for a, batch in sorted(first.items()):
        bg = batch.to(dev)
        with torch.no_grad():
            m = model(bg)
            m_r = model(bg.replace(pos=bg.pos @ rot.T))
            m_c = cpu(_mols(batch, slice(0, PH_CPU_MOLS)))
        row = {"shape": list(batch.z.shape), "orbitals": batch.orb_mask.shape[1]}
        for name in names:
            mat = m[name]
            scale = _max_abs(mat)
            check(torch.equal(mat, mat.transpose(-1, -2)), f"{name} symmetric at A={a}")
            err_c = _max_abs(mat[:PH_CPU_MOLS].cpu() - m_c[name])
            check(err_c <= QH_H_RTOL * scale, f"{name} card vs CPU at A={a}: {err_c} vs {scale}")
            cov = 0.0
            for k in range(batch.z.shape[0]):
                if bool(batch.graph_mask[k]):
                    zs = batch.z[k][batch.node_mask[k]].tolist()
                    t = orbital_rotation(zs, orbitals, rot, mat.shape[-1])
                    cov = max(cov, _max_abs(m_r[name][k].double() - t @ mat[k].double() @ t.T))
            check(cov <= QH_COV_RTOL * scale, f"{name} covariance at A={a}: {cov} vs {scale}")
            row.update({f"{name}_max_abs": scale, f"{name}_abs_err_vs_cpu": err_c,
                        f"{name}_max_abs_covariance_err": cov})
        # S's environment independence: molecule 0's first C becomes N
        zs = batch.z[0][batch.node_mask[0]].tolist()
        k = zs.index(6)
        z2 = bg.z.clone()
        z2[0, k] = 7
        with torch.no_grad():
            s2 = model(bg.replace(z=z2))["overlap"][0]
        offs = np.cumsum([0] + [norb[z] for z in zs])
        keep = torch.ones(m["overlap"].shape[-1], dtype=torch.bool, device=dev)
        keep[int(offs[-1]):] = False
        keep[int(offs[k]):int(offs[k + 1])] = False
        s_other = m["overlap"][0][keep][:, keep]
        env = _max_abs(s2[keep][:, keep] - s_other)
        check(env <= PH_ENV_RTOL * _max_abs(s_other),
              f"S of the other atoms moved by {env} when atom {k} changed species at A={a}")
        row.update({"overlap_environment_abs_err": env, "species_changed_atom": k})
        out.append(row)
    check(sorted(first) == list(BUCKETS), f"model check buckets {sorted(first)}")
    return out


def energy_predict_phase(tmp: Path, db: Path, family: str) -> dict:
    """`job_type: predict` of DimeNet++, Graphormer3D or GemNet-OC at full
    width over the seeded DB from the train phase's best checkpoint (DimeNet++'s
    zero-initialised output projections make the untrained model's forces
    0): rows and finite values, no kernel of A-P; per bucket the first
    batch on the card in eval mode (the job's rows are its outputs, so the
    job dropped nothing; its forces not all 0), its first ENERGY_CPU_MOLS molecules
    against the CPU with the same weights, and the batch rotated (E
    invariant; F covariant for DimeNet++, its error printed for
    Graphormer3D); molecules/s of the predict loop, run on a model left in
    train mode with a fresh dropout generator (Graphormer3D: the loop must
    draw nothing from it and leave the model in train mode), the device's
    busy share over two predict steps, peak memory; GemNet-OC's two triplet
    paths per bucket (`gemnet_paths`)."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.models.base import forward
    from nabladft_tpu_torch.train import Trainer

    fam = ENERGY[family]
    ckpt = tmp / f"ckpt_{family}"
    best = ckpt / json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
    cfg = dict(smoke_config(str(db), str(tmp / f"predictions_{family}.db"), str(tmp),
                            config=fam["config"]), ckpt_path=str(best))
    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    res = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    peak_mem = torch.cuda.max_memory_allocated()
    check(res["rows"] == N_MOLS, f"rows written {res['rows']} != {N_MOLS}")
    check(not any(launches.values()), f"{family} predict launched kernels of A-P: {launches}")
    dm = pipelines.build_datamodule(cfg)
    order = [mid for b in dm.predict_dataloader()
             for mid, real in zip(b.mol_id.tolist(), b.graph_mask.tolist()) if real]
    out_rows = dict(zip(order, AseDatabase(cfg["output_db"]).select_all()))
    check(len(out_rows) == N_MOLS, "output DB row count")
    for rec in out_rows.values():
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(e.shape == (1,) and f.shape == (rec.natoms, 3), "prediction shapes")
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite predictions")
    shapes = sorted({tuple(b.z.shape) for b in dm.predict_dataloader()})
    check(all(s in [(fam["batch"], a) for a in BUCKETS] for s in shapes),
          f"predict batch shapes {shapes}")

    dev = torch.device("cuda")
    gpu = Trainer(pipelines.build_model(cfg, dev).eval(), dev)
    cpu = Trainer(pipelines.build_model(cfg, torch.device("cpu")).eval(), "cpu")
    gpu.load_checkpoint(best)
    cpu.load_checkpoint(best)
    first = {}
    for batch in dm.predict_dataloader():
        first.setdefault(batch.z.shape[1], batch)
    rot = torch.from_numpy(rotation()).to(dev)
    e_mean = float(cfg["model"]["kwargs"].get("energy_mean", 0.0))
    checks = []
    for a, batch in sorted(first.items()):
        bg = batch.to(dev)
        out, out_r = forward(gpu.model, bg), forward(gpu.model, bg.replace(pos=bg.pos @ rot.T))
        out_c = forward(cpu.model, _mols(batch, slice(0, ENERGY_CPU_MOLS)))
        for i, mol_id in enumerate(batch.mol_id.tolist()):
            if bool(batch.graph_mask[i]):
                got = out_rows[mol_id].data["energy_pred"][0]
                check(abs(got - float(out["energy"][i])) <= 1e-6 * max(abs(got), 1.0),
                      "job rows = the model's outputs")
        row = {"shape": list(batch.z.shape), "max_abs_energy": _max_abs(out["energy"]),
               "max_abs_force": _max_abs(out["forces"])}
        check(row["max_abs_force"] > 0.0, f"{family} forces all 0 at A={a}")
        for tag, got, want in (
                ("cpu", {k: v[:ENERGY_CPU_MOLS].cpu() for k, v in out.items()}, out_c),
                ("rotation", out_r, {"energy": out["energy"], "forces": out["forces"] @ rot.T})):
            for k in ("energy", "forces"):
                g, w = got[k].double(), want[k].double().to(got[k].device)
                diff = (g - w).abs()
                if k == "energy":
                    limit = _energy_limit(w, batch.n_atoms[:len(w)].to(w.device), e_mean)
                else:
                    limit = F_TOL["atol"] + F_TOL["rtol"] * _max_abs(w)
                err, share = _max_abs(diff), float((diff / limit).max())
                row[f"{k}_abs_err_vs_{tag}"] = err
                row[f"{k}_err_over_limit_vs_{tag}"] = share
                if tag == "rotation" and k == "forces" and not fam["f_covariant"]:
                    continue
                check(share <= 1.0, f"{family} {k} at A={a} vs {tag}: {err}, {share} of its limit")
        if family == "gemnet_oc":
            row.update(gemnet_paths(gpu.model, bg))
        checks.append(row)
    check(sorted(first) == list(BUCKETS), f"predict buckets {sorted(first)}")
    del cpu

    gpu.model.train()
    if fam["dropout"]:
        gpu.model.dropout_generator = torch.Generator(device=dev).manual_seed(0)
    rates = []
    for p in range(ENERGY_PASSES + 1):
        t0 = time.perf_counter()
        n_pred = sum(len(o["energy"]) for o in gpu.predict(dm.predict_dataloader()))
        torch.cuda.synchronize()
        if p:
            rates.append(n_pred / (time.perf_counter() - t0))
    check(gpu.model.training, "predict restores the model's train mode")
    draws = gpu.model.dropout_generator.get_offset() if fam["dropout"] else 0
    check(draws == 0, f"dropout drawn on predict: generator offset {draws}")
    profile_phase(f"{family}_profile", gpu, dm)
    emit(f"{family}_predict", config=fam["config"], rows=res["rows"], batches=res["batches"],
         batch_shapes=shapes, launches=launches, dropout_generator_offset=draws,
         run_seconds=res["seconds"], checks=checks,
         molecules_per_second=_rates(sorted(rates), "passes"),
         peak_device_memory_bytes=peak_mem,
         tolerances={"energy": dict(E_TOL, ulps=E_ULPS), "forces": F_TOL})
    return launches


def energy_train_phase(tmp: Path, db: Path, family: str) -> dict:
    """The train (TRAIN_EPOCHS epochs) and test jobs of DimeNet++ (derivative
    forces by the double backward), Graphormer3D or GemNet-OC (direct
    forces) at full width: no kernel of A-P; GemNet-OC's scale factors
    (`gemnet_scale_checks`) and its clip acting; Graphormer3D's dropout drawn on train steps
    (the trainer's generator, seeded afresh each step, has moved after one)
    and not in validation (it has not moved across one); DimeNet++ has no
    generator; finite losses and metrics; molecules/s, seconds per epoch, peak memory, and the busy share
    over two train steps."""
    from nabladft_tpu_torch import pipelines

    fam = ENERGY[family]
    ckpt, outputs = tmp / f"ckpt_{family}", tmp / f"outputs_{family}"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config=fam["config"])
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    res, test, launches, peak_mem, t_start, best = _train_job(cfg, ckpt)
    check(not any(launches.values()), f"{family} train/test launched kernels of A-P: {launches}")
    check((ckpt / "last.ckpt").exists() and best.exists(), "checkpoint files")
    step_rows, rates, epoch_seconds = _train_readings(cfg, res, test, ("energy", "forces"),
                                                      t_start, n_train)
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None),
                                      torch.device("cuda"))
    check(trainer._force_grads == "direct"
          and trainer._uses_forces() == (family == "dimenetpp"), "force training route")
    scales = gemnet_scale_checks(cfg, dm, trainer, ckpt) if family == "gemnet_oc" else None
    before = {n: p.detach().clone() for n, p in trainer.scales.items()}
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    profile_steps(f"{family}_train_profile", trainer._train_step, batches)
    check(all(torch.equal(p, before[n]) for n, p in trainer.scales.items()),
          "train steps moved a scale factor")
    grad_norm_max = max(r["grad_norm"] for r in step_rows)
    if family == "gemnet_oc":
        check(grad_norm_max > trainer.cfg.grad_clip, f"the clip never acted: {grad_norm_max}")
    gen = trainer._dropout_gen
    check((gen is not None) == fam["dropout"], f"{family} dropout generator {gen}")
    draws = {}
    if gen is not None:
        draws["train_step"] = gen.get_offset()
        trainer.validate(itertools.islice(dm.val_dataloader(), 1))
        draws["validation"] = gen.get_offset() - draws["train_step"]
        check(draws["train_step"] > 0 and draws["validation"] == 0,
              f"dropout generator offsets {draws}: drawn in a train step, not in validation")
    emit(f"{family}_train", config=fam["config"], steps=res["step"], batches_per_epoch=n_train,
         val_batches=n_val, test_batches=n_test, launches=launches,
         dropout_generator_offsets=draws, scale_factors=scales,
         final_val=res, test=test,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         grad_norm_max=grad_norm_max, grad_clip=trainer.cfg.grad_clip,
         molecules_per_second=dict(_rates(rates, "steps"), epoch=TRAIN_EPOCHS - 1),
         seconds_per_epoch=epoch_seconds, peak_device_memory_bytes=peak_mem)
    return launches


# ---------------------------------------------------------------------------
# restore: the reference's published checkpoints through the registry, and
# the JAX package's flax checkpoints
# ---------------------------------------------------------------------------

# the restore phases' DB: one predict batch (BATCH molecules of the first
# bucket's sizes), seeded apart from the main DB
RESTORE_SEED, RESTORE_MAX_ATOMS = SEED + 1, BUCKETS[0]
# molecules of the batch held against the CPU plain path
RESTORE_CPU_MOLS, QH_RESTORE_CPU_MOLS = 4, 2
# fine-tune steps from the converted QHNet checkpoint
QH_RESTORE_STEPS = 2
# the flax-restore test job against the same weights carried in as params:
# every metric within this relative distance (the same kernels on the same
# inputs repeat their bits; the limit only absorbs a reordered host sum)
FLAX_METRIC_RTOL = 1e-6


def _painn(source: str, root: str) -> dict:
    """configs/painn.yaml: model/painn (schnetpack's PaiNN: cosine cutoff),
    trainer/default, datamodule/energy."""
    return _composed("painn", {
        "name": "painn",
        "kwargs": {"hidden": 128, "n_interactions": 6, "n_rbf": 100, "cutoff": 5.0,
                   "max_neighbors": 63, "rbf": "gaussian", "envelope": "cosine"},
        "loss_specs": {"energy": "mse", "forces": "mse"},
        "loss_coefs": {"energy": 1.0, "forces": 1.0},
    }, source, root)


CONFIGS["painn"] = _painn


def seeded_state(shapes: dict, seed: int, unit_vectors=()) -> dict:
    """Seeded float32 CPU tensors of `shapes` under the reference's names:
    matrices N(0, 1/fan_in) (fan_in the last axis), vectors N(0, 0.1²) but
    those ending in one of `unit_vectors` N(0, 1) (e3nn's flat weights)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        x = rng.normal(size=s)
        if len(s) >= 2:
            x = x / np.sqrt(s[-1])
        elif not k.endswith(tuple(unit_vectors)):
            x = x * 0.1
        out[k] = torch.from_numpy(np.asarray(x, np.float32))
    return out


def painn_reference_shapes(f: int, n_layers: int, n_rbf: int) -> dict:
    """schnetpack's PaiNN inside a NeuralNetworkPotential (the published
    PaiNN checkpoints' names)."""
    pre, out = "model.representation.", "model.output_modules.0.outnet."
    shapes = {pre + "embedding.weight": (100, f), pre + "filter_net.weight": (n_layers * 3 * f, n_rbf),
              pre + "filter_net.bias": (n_layers * 3 * f,),
              out + "0.weight": (f // 2, f), out + "0.bias": (f // 2,),
              out + "1.weight": (1, f // 2), out + "1.bias": (1,)}
    for i in range(n_layers):
        b, u = f"{pre}interactions.{i}.", f"{pre}mixing.{i}."
        shapes.update({
            b + "interatomic_context_net.0.weight": (f, f), b + "interatomic_context_net.0.bias": (f,),
            b + "interatomic_context_net.1.weight": (3 * f, f),
            b + "interatomic_context_net.1.bias": (3 * f,),
            u + "mu_channel_mix.weight": (2 * f, f),
            u + "intraatomic_context_net.0.weight": (f, 2 * f),
            u + "intraatomic_context_net.0.bias": (f,),
            u + "intraatomic_context_net.1.weight": (3 * f, f),
            u + "intraatomic_context_net.1.bias": (3 * f,)})
    return shapes


def escn_reference_shapes(model) -> dict:
    """The reference eSCN's (escn/escn.py) at `model`'s widths."""
    L, M, C = model.l_max, model.m_max, model.c
    layer = model.layers[0]
    H, EC = layer.w1_0.shape[-1], layer.edge_block.fc_edge.in_features
    n_gauss, n_z = layer.edge_block.fc_dist.in_features, model.sphere_embedding.num_embeddings
    shapes = {"sphere_embedding.weight": (n_z, C)}
    for i in range(model.num_layers):
        mb = f"layer_blocks.{i}.message_block."
        shapes.update({mb + "edge_block.fc1_dist.weight": (EC, n_gauss),
                       mb + "edge_block.fc1_dist.bias": (EC,),
                       mb + "edge_block.source_embedding.weight": (n_z, EC),
                       mb + "edge_block.target_embedding.weight": (n_z, EC),
                       mb + "edge_block.fc1_edge_attr.weight": (EC, EC),
                       mb + "edge_block.fc1_edge_attr.bias": (EC,)})
        for blk in ("so2_block_source", "so2_block_target"):
            b = mb + blk + "."
            shapes.update({b + "fc1_dist0.weight": (H, EC), b + "fc1_dist0.bias": (H,),
                           b + "fc1_m0.weight": (H, (L + 1) * C),
                           b + "fc2_m0.weight": ((L + 1) * C, H)})
            for m in range(1, M + 1):
                c, n_l = b + f"so2_conv.{m - 1}.", L + 1 - m
                shapes.update({c + "fc1_dist.weight": (2 * H, EC), c + "fc1_dist.bias": (2 * H,),
                               c + "fc1_r.weight": (H, n_l * C), c + "fc2_r.weight": (n_l * C, H),
                               c + "fc1_i.weight": (H, n_l * C), c + "fc2_i.weight": (n_l * C, H)})
        shapes.update({f"layer_blocks.{i}.fc1_sphere.weight": (C, 2 * C),
                       f"layer_blocks.{i}.fc2_sphere.weight": (C, C),
                       f"layer_blocks.{i}.fc3_sphere.weight": (C, C)})
    for blk in ("energy_block", "force_block"):
        shapes.update({blk + ".fc1.weight": (C, C), blk + ".fc1.bias": (C,),
                       blk + ".fc2.weight": (C, C), blk + ".fc2.bias": (C,),
                       blk + ".fc3.weight": (1, C)})
    return shapes


def eqv2_reference_shapes(model) -> dict:
    """The reference EquiformerV2_OC20's (use_m_share_rad False, per-block
    atom-edge embeddings) at `model`'s widths."""
    L, M, C, EC = model.l_max, model.m_max, model.c, model.edge_channels
    H, VA, VC = model.num_heads, model.attn_alpha_channels, model.attn_value_channels
    HID, NB = model.attn_hidden_channels or H * VC, model.num_distance_basis
    FFN, n_z, N0 = model.energy_block.scalar_mlp.out_features, \
        model.sphere_embedding.num_embeddings, L + 1

    def radial(prefix, cin, cout):
        return {prefix + ".net.0.weight": (EC, cin), prefix + ".net.0.bias": (EC,),
                prefix + ".net.1.weight": (EC,), prefix + ".net.1.bias": (EC,),
                prefix + ".net.3.weight": (EC, EC), prefix + ".net.3.bias": (EC,),
                prefix + ".net.4.weight": (EC,), prefix + ".net.4.bias": (EC,),
                prefix + ".net.6.weight": (cout, EC), prefix + ".net.6.bias": (cout,)}

    def attn(prefix, out):
        extra = H * VA + HID
        s = {prefix + ".source_embedding.weight": (n_z, EC),
             prefix + ".target_embedding.weight": (n_z, EC),
             prefix + ".alpha_norm.weight": (VA,), prefix + ".alpha_norm.bias": (VA,),
             prefix + ".alpha_dot": (H, VA), prefix + ".proj.weight": (N0, out, H * VC),
             prefix + ".proj.bias": (out,),
             prefix + ".so2_conv_1.fc_m0.weight": (extra + N0 * HID, N0 * 2 * C),
             prefix + ".so2_conv_1.fc_m0.bias": (extra + N0 * HID,),
             prefix + ".so2_conv_2.fc_m0.weight": (N0 * H * VC, N0 * HID),
             prefix + ".so2_conv_2.fc_m0.bias": (N0 * H * VC,)}
        s.update(radial(prefix + ".so2_conv_1.rad_func", NB + 2 * EC,
                        sum((L + 1 - m) * 2 * C for m in range(M + 1))))
        for m in range(1, M + 1):
            n_l = L + 1 - m
            s[prefix + f".so2_conv_1.so2_m_conv.{m - 1}.fc.weight"] = (2 * HID * n_l, n_l * 2 * C)
            s[prefix + f".so2_conv_2.so2_m_conv.{m - 1}.fc.weight"] = (2 * H * VC * n_l, n_l * HID)
        return s

    def ffn(prefix, out):
        return {prefix + ".scalar_mlp.0.weight": (FFN, C), prefix + ".scalar_mlp.0.bias": (FFN,),
                prefix + ".so3_linear_1.weight": (N0, FFN, C),
                prefix + ".so3_linear_1.bias": (FFN,),
                prefix + ".grid_mlp.0.weight": (FFN, FFN), prefix + ".grid_mlp.2.weight": (FFN, FFN),
                prefix + ".grid_mlp.4.weight": (FFN, FFN),
                prefix + ".so3_linear_2.weight": (N0, out, FFN),
                prefix + ".so3_linear_2.bias": (out,)}

    def norm(prefix):
        return {prefix + ".norm_l0.weight": (C,), prefix + ".norm_l0.bias": (C,),
                prefix + ".affine_weight": (L, C)}

    shapes = {"sphere_embedding.weight": (n_z, C),
              "edge_degree_embedding.source_embedding.weight": (n_z, EC),
              "edge_degree_embedding.target_embedding.weight": (n_z, EC)}
    shapes.update(radial("edge_degree_embedding.rad_func", NB + 2 * EC, N0 * C))
    for i in range(model.num_layers):
        b = f"blocks.{i}"
        for part in (norm(b + ".norm_1"), attn(b + ".ga", C), norm(b + ".norm_2"),
                     ffn(b + ".ffn", C)):
            shapes.update(part)
    shapes.update(norm("norm"))
    shapes.update(ffn("energy_block", 1))
    shapes.update(attn("force_block", 1))
    return shapes


def qhnet_reference_shapes(model) -> dict:
    """The reference QHNet's (qhnet/qhnet.py, layers.py: e3nn flat weights)
    at `model`'s widths and orbital layout."""
    from nabladft_tpu_torch.models.qhnet import LMAX
    from nabladft_tpu_torch.ops import e3nn_compat as ec

    C, CB, RBF, N_L = model.hidden, model.bottle_hidden, model.rbf_dim, LMAX + 1
    uuu_n = len(ec.qhnet_uuu_tp(LMAX).paths)
    _, n_w, n_b = ec.expansion_instructions(tuple(model.layout.mults), CB, LMAX)
    shapes = {"node_embedding.weight": (10, C), "distance_expansion._alpha": ()}

    def gate(prefix):
        return {prefix + ".fc.0.weight": (N_L * C, N_L * C), prefix + ".fc.0.bias": (N_L * C,),
                prefix + ".fc.2.weight": (N_L * C, N_L * C), prefix + ".fc.2.bias": (N_L * C,)}

    def linear(prefix, c_out=C):
        return {prefix + ".weight": (N_L * C * c_out,), prefix + ".bias": (c_out,)}

    for i in range(model.num_layers):
        r = f"e3_gnn_layer.{i}.conv"
        numel = len(ec.qhnet_conv_tp(LMAX, layer0=(i == 0)).paths) * C
        shapes.update({f"{r}.fc_node.0.weight": (RBF, 32), f"{r}.fc_node.1.weight": (32, numel),
                       f"{r}.layer_l0.0.weight": (2 * C if i == 0 else (N_L + 1) * C, 32),
                       f"{r}.layer_l0.1.weight": (32, numel)})
        shapes.update(linear(f"{r}.linear_out"))
        if i != 0:
            for part in (linear(f"{r}.linear_node_pre"), linear(f"{r}.linear_node"),
                         gate(f"{r}.norm_gate")):
                shapes.update(part)
    for k in range(model.num_layers - model.start_layer - 1):
        r = f"e3_gnn_node_layer.{k}"
        for name in ("linear_node_1", "linear_node_2", "linear_node_3"):
            shapes.update(linear(f"{r}.{name}"))
        for name in ("norm_gate", "norm_gate_1", "norm_gate_2"):
            shapes.update(gate(f"{r}.{name}"))
        shapes[f"{r}.tp.weight"] = (uuu_n * C,)
        r = f"e3_gnn_node_pair_layer.{k}"
        for name in ("linear_node_pair_inner", "linear_node_pair_n", "linear_node_pair"):
            shapes.update(linear(f"{r}.{name}"))
        for name in ("norm_gate", "norm_gate_pre"):
            shapes.update(gate(f"{r}.{name}"))
        shapes.update({f"{r}.fc_node_pair.0.weight": (RBF, 8),
                       f"{r}.fc_node_pair.1.weight": (8, uuu_n * C),
                       f"{r}.fc.0.weight": (C, (N_L + 1) * C), f"{r}.fc.0.bias": (C,),
                       f"{r}.fc.2.weight": (uuu_n * C, C), f"{r}.fc.2.bias": (uuu_n * C,)})
    for name in ("output_ii", "output_ij"):
        shapes.update(linear(name, CB))
    for name, d_in, d_out in (("fc_ii.hamiltonian", C, n_w), ("fc_ij.hamiltonian", 2 * C, n_w),
                              ("fc_ii_bias.hamiltonian", C, n_b),
                              ("fc_ij_bias.hamiltonian", 2 * C, n_b)):
        shapes.update({f"{name}.0.weight": (C, d_in), f"{name}.0.bias": (C,),
                       f"{name}.2.weight": (d_out, C), f"{name}.2.bias": (d_out,)})
    return shapes


def lightning_ckpt(path: Path, state: dict) -> None:
    """A Lightning-shaped .ckpt of `state` whose hyper_parameters hold an
    object of a class from a module that is gone when the file is read."""
    import types

    mod = types.ModuleType("vanished_training_module")

    class HyperParameters:
        def __init__(self):
            self.lr = 5e-4

    HyperParameters.__module__, HyperParameters.__qualname__ = mod.__name__, "HyperParameters"
    mod.HyperParameters = HyperParameters
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"state_dict": state, "hyper_parameters": {"model": HyperParameters()},
                    "epoch": 1}, path)
    finally:
        del sys.modules[mod.__name__]


def cached_checkpoint(tmp: Path, name: str, state: dict) -> dict:
    """The config keys that reach checkpoint `name` through the registry's
    cache: the file at <tmp>/pretrained/<name>.ckpt and a links file whose
    etag for `name` is its MD5."""
    from nabladft_tpu_torch.data.download import file_md5

    cache = tmp / "pretrained"
    cache.mkdir(exist_ok=True)
    lightning_ckpt(cache / f"{name}.ckpt", state)
    links = tmp / f"links_{name}.json"
    links.write_text(json.dumps({"checkpoints": {name: {
        "url": f"https://checkpoints.invalid/{name}.ckpt",
        "etag": file_md5(cache / f"{name}.ckpt")}}}))
    return {"pretrained": name, "pretrained_dir": str(cache), "links_path": str(links)}


class NoFetch:
    """`urllib.request.urlopen` raises while it is entered: nothing is fetched."""

    def __enter__(self):
        import urllib.request

        self._urlopen = urllib.request.urlopen

        def refuse(*args, **kwargs):
            raise RuntimeError("a download was attempted")

        urllib.request.urlopen = refuse

    def __exit__(self, *exc):
        import urllib.request

        urllib.request.urlopen = self._urlopen


def _restore_rows(cfg: dict, dm) -> dict:
    """mol_id -> the predict job's output row (the writer keeps the loader's
    order of the real molecules)."""
    from nabladft_tpu_torch.data.ase_codec import AseDatabase

    order = [mid for b in dm.predict_dataloader()
             for mid, real in zip(b.mol_id.tolist(), b.graph_mask.tolist()) if real]
    return dict(zip(order, AseDatabase(cfg["output_db"]).select_all()))


def _rows_against_cpu(cfg: dict, dm, n_mols: int, tol) -> dict:
    """The first `n_mols` molecules of the predict job's batch against the
    CPU plain path with the same converted weights; `tol(got, want, what)`
    holds each; returns the largest abs errors."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.models.base import forward

    rows = _restore_rows(cfg, dm)
    with NoFetch():
        cpu = pipelines.build_model(cfg, torch.device("cpu")).eval()
    check(cpu.use_pallas == "off", "the CPU reference runs the plain path")
    batch = _mols(next(iter(dm.predict_dataloader())), slice(0, n_mols))
    with torch.no_grad():
        out = forward(cpu, batch)
    errs = {"energy": 0.0, "forces": 0.0}
    for i, mol_id in enumerate(batch.mol_id.tolist()):
        rec = rows[mol_id]
        got = {"energy": np.asarray(rec.data["energy_pred"]),
               "forces": np.asarray(rec.data["forces_pred"])}
        want = {"energy": out["energy"][i:i + 1].numpy(),
                "forces": out["forces"][i][:rec.natoms].numpy()}
        for k in errs:
            tol(got[k], want[k], f"{k} of molecule {mol_id}")
            errs[k] = max(errs[k], float(np.abs(got[k] - want[k]).max()))
    return errs


def _pretrained_predict(tmp: Path, db: Path, config: str, name: str, state_fn,
                        kwargs: dict = None):
    """`job_type: predict` of configs/<config>.yaml (model kwargs updated by
    `kwargs`) with ``pretrained: <name>``, the state dict `state_fn(model)`
    (a CPU model of the config) found in the cache and nothing fetched;
    returns (cfg, result, launches, peak memory, datamodule, state)."""
    from nabladft_tpu_torch import pipelines

    cfg = smoke_config(str(db), str(tmp / f"predictions_{name}.db"), str(tmp), config=config)
    cfg["model"] = dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"], **(kwargs or {})))
    state = state_fn(pipelines.build_model(cfg, torch.device("cpu")))
    cfg.update(cached_checkpoint(tmp, name, state))

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    with NoFetch():
        res = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    dm = pipelines.build_datamodule(cfg)
    check(res["rows"] == BATCH and res["batches"] == 1,
          f"{name}: {res['rows']} rows in {res['batches']} batches")
    return cfg, res, launches, torch.cuda.max_memory_allocated(), dm, state


def _want(launches: dict, **counts) -> dict:
    want = dict.fromkeys(launches, 0)
    want.update(counts)
    return want


def pretrained_painn_phase(tmp: Path, db: Path) -> dict:
    """PaiNN_train_tiny (a seeded schnetpack-named state dict at
    configs/painn.yaml width in a Lightning .ckpt) predicted on the card:
    A and B once per interaction, the rows against the CPU."""
    kw = _painn("", "")["model"]["kwargs"]
    f, n_layers = kw["hidden"], kw["n_interactions"]
    cfg, res, launches, peak, dm, state = _pretrained_predict(
        tmp, db, "painn", "PaiNN_train_tiny",
        lambda model: seeded_state(painn_reference_shapes(f, n_layers, kw["n_rbf"]), SEED + 2))
    want = _want(launches, painn_fwd=n_layers, painn_bwd=n_layers)
    check(launches == want, f"pretrained PaiNN launches {launches}, expected {want}")
    from nabladft_tpu_torch import pipelines

    with NoFetch():
        model = pipelines.build_model(cfg, torch.device("cpu"))
    check(torch.equal(model.atom_embedding.weight,
                      state["model.representation.embedding.weight"]), "the checkpoint's weights")
    errs = _rows_against_cpu(cfg, dm, RESTORE_CPU_MOLS, lambda got, ref, what:
                             np.testing.assert_allclose(got, ref, err_msg=what,
                                                        **(F_TOL if "forces" in what else E_TOL)))
    emit("pretrained_painn", checkpoint=cfg["pretrained"], config="painn", rows=res["rows"],
         run_seconds=res["seconds"], launches=launches, cpu_ref_molecules=RESTORE_CPU_MOLS,
         cpu_ref_max_abs_err=errs, peak_device_memory_bytes=peak,
         tolerances={"energy": E_TOL, "forces": F_TOL})
    return launches


def _direct_tol(scale: dict, rtol: float):
    def tol(got, ref, what):
        k = "forces" if "forces" in what else "energy"
        err = float(np.abs(got - ref).max())
        check(err <= rtol * scale[k], f"{what}: {err} > {rtol} x {scale[k]}")
    return tol


def pretrained_escn_phase(tmp: Path, db: Path) -> dict:
    """ESCN-OC_train_tiny (a seeded reference-named eSCN state dict at
    configs/escn-oc.yaml width; the converter's XLA layout mapped to the
    fused one) predicted on the card: M once per layer, N never; the first
    molecules against the CPU within ESCN_OUT_RTOL x the largest |E| / |F|."""
    cfg, res, launches, peak, dm, _ = _pretrained_predict(
        tmp, db, "escn-oc", "ESCN-OC_train_tiny",
        lambda model: seeded_state(escn_reference_shapes(model), SEED + 3))
    want = _want(launches, escn_fwd=cfg["model"]["kwargs"]["num_layers"])
    check(launches == want, f"pretrained eSCN launches {launches}, expected {want}")
    rows = _restore_rows(cfg, dm).values()
    scale = {"energy": max(abs(r.data["energy_pred"][0]) for r in rows),
             "forces": max(float(np.abs(r.data["forces_pred"]).max()) for r in rows)}
    errs = _rows_against_cpu(cfg, dm, ESCN_CPU_MOLS, _direct_tol(scale, ESCN_OUT_RTOL))
    emit("pretrained_escn", checkpoint=cfg["pretrained"], config="escn-oc", rows=res["rows"],
         run_seconds=res["seconds"], launches=launches, cpu_ref_molecules=ESCN_CPU_MOLS,
         cpu_ref_max_abs_err=errs, max_abs=scale, peak_device_memory_bytes=peak,
         tolerances={"output_rel": ESCN_OUT_RTOL})
    return launches


# the published EquiformerV2 checkpoints' variant (equiformer_v2_oc20.yaml)
EQV2_REF_KW = dict(m_share_rad=False, num_distance_basis=600, attn_hidden_channels=64)


def pretrained_eqv2_phase(tmp: Path, db: Path) -> dict:
    """Equiformer-v2_train_tiny (a seeded reference-named state dict at
    configs/equiformer_v2.yaml width, m_share_rad False, 600 Gaussians)
    predicted on the card by the plain path the variant chooses: O and P
    never launch; the first molecule against the CPU within EQV2_OUT_RTOL x
    the largest |E| / |F|."""
    cfg, res, launches, peak, dm, _ = _pretrained_predict(
        tmp, db, "equiformer_v2", "Equiformer-v2_train_tiny",
        lambda model: seeded_state(eqv2_reference_shapes(model), SEED + 4), EQV2_REF_KW)
    check(launches == _want(launches), f"pretrained EquiformerV2 launched {launches}")
    rows = _restore_rows(cfg, dm).values()
    scale = {"energy": max(abs(r.data["energy_pred"][0]) for r in rows),
             "forces": max(float(np.abs(r.data["forces_pred"]).max()) for r in rows)}
    errs = _rows_against_cpu(cfg, dm, EQV2_CPU_MOLS, _direct_tol(scale, EQV2_OUT_RTOL))
    emit("pretrained_eqv2", checkpoint=cfg["pretrained"], config="equiformer_v2",
         model_kwargs=EQV2_REF_KW, rows=res["rows"], run_seconds=res["seconds"],
         launches=launches, cpu_ref_molecules=EQV2_CPU_MOLS, cpu_ref_max_abs_err=errs,
         max_abs=scale, peak_device_memory_bytes=peak, tolerances={"output_rel": EQV2_OUT_RTOL})
    return launches


def pretrained_qhnet_phase(tmp: Path) -> dict:
    """QHNet_train_tiny (a seeded reference-named state dict at
    configs/qhnet.yaml width, ref_compat) over qhnet_train's Hamiltonian
    DB: `test`, then QH_RESTORE_STEPS fine-tune steps from the converted
    weights (I-L with remat as in qhnet_train); H of the first test batch's
    first molecules on the card within QH_H_RTOL x max |H| of the CPU."""
    from nabladft_tpu_torch import pipelines

    db = tmp / "hamiltonian.db"
    ckpt, outputs = tmp / "ckpt_qhnet_pretrained", tmp / "outputs_qhnet_pretrained"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs), config="qhnet")
    cfg["model"] = dict(cfg["model"], kwargs=dict(cfg["model"]["kwargs"], ref_compat=True))
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=1, max_steps=QH_RESTORE_STEPS)
    state = seeded_state(qhnet_reference_shapes(pipelines.build_model(cfg, torch.device("cpu"))),
                         SEED + 5, unit_vectors=("linear_out.weight", "linear_node_pre.weight",
                                                 "linear_node.weight", "_1.weight", "_2.weight",
                                                 "_3.weight", "tp.weight", "_inner.weight",
                                                 "_n.weight", "pair.weight", "output_ii.weight",
                                                 "output_ij.weight"))
    state["distance_expansion._alpha"] = torch.tensor(float(np.log(np.expm1(0.5))) + 0.1)
    cfg.update(cached_checkpoint(tmp, "QHNet_train_tiny", state))
    dm = pipelines.build_datamodule(cfg)
    n_val, n_test = len(dm.val_dataloader()), len(dm.test_dataloader())

    # the main path: counts reset just before, read just after
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    with NoFetch():
        test = pipelines.run(dict(cfg, job_type="test"))
        res = pipelines.run(cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()

    n_layers, start = cfg["model"]["kwargs"]["num_layers"], 2
    n_pair, steps = n_layers - 1 - start, res["step"]
    check(steps == QH_RESTORE_STEPS, f"{steps} fine-tune steps")
    evals = n_val + n_test
    want = _want(launches, qhnet_conv_fwd=2 * n_layers * steps + n_layers * evals,
                 qhnet_conv_bwd=n_layers * steps,
                 qhnet_pair_fwd=2 * n_pair * steps + n_pair * evals, qhnet_pair_bwd=n_pair * steps)
    check(launches == want, f"pretrained QHNet launches {launches}, expected {want}")
    for m in (test, res):
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")

    from nabladft_tpu_torch.models.base import forward

    with NoFetch():
        gpu = pipelines.build_model(cfg, torch.device("cuda")).eval()
        cpu = pipelines.build_model(cfg, torch.device("cpu")).eval()
    check(gpu.use_pallas == "fused" and cpu.use_pallas == "off" and gpu.ref_compat, "model modes")
    batch = _mols(next(iter(dm.test_dataloader())), slice(0, QH_RESTORE_CPU_MOLS))
    with torch.no_grad():
        h_gpu = forward(gpu, batch.to("cuda"))["hamiltonian"].cpu()
        h_cpu = forward(cpu, batch)["hamiltonian"]
    err, scale = _max_abs(h_gpu - h_cpu), _max_abs(h_cpu)
    check(err <= QH_H_RTOL * scale, f"pretrained QHNet H: {err} > {QH_H_RTOL} x {scale}")
    emit("pretrained_qhnet", checkpoint=cfg["pretrained"], config="qhnet", ref_compat=True,
         test=test, fine_tune=res, steps=steps, launches=launches, expected_launches=want,
         h_cpu_molecules=QH_RESTORE_CPU_MOLS, h_max_abs_err=err, h_max_abs=scale,
         peak_device_memory_bytes=peak, tolerances={"h_rel": QH_H_RTOL})
    return launches


def _msgpack(obj) -> bytes:
    """flax's msgpack (maps of str keys, ndarrays as extension type 1 of
    msgpack ``(shape, dtype name, bytes)``, ints, nil): enough to write a
    TrainState the JAX package's CheckpointManager would."""
    import struct

    def head(n, fix, fix_max, c16, c32):
        if n <= fix_max:
            return bytes([fix | n])
        return (bytes([c16]) + struct.pack(">H", n)) if n < 1 << 16 else \
            (bytes([c32]) + struct.pack(">I", n))

    if obj is None:
        return b"\xc0"
    if isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        return b"\xd3" + struct.pack(">q", int(obj))
    if isinstance(obj, str):
        b = obj.encode()
        return (bytes([0xA0 | len(b)]) if len(b) < 32 else b"\xd9" + bytes([len(b)])) + b
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    if isinstance(obj, (list, tuple)):
        return head(len(obj), 0x90, 15, 0xDC, 0xDD) + b"".join(_msgpack(x) for x in obj)
    if isinstance(obj, dict):
        return head(len(obj), 0x80, 15, 0xDE, 0xDF) + b"".join(
            _msgpack(k) + _msgpack(v) for k, v in obj.items())
    if isinstance(obj, np.ndarray):
        body = _msgpack([list(obj.shape), obj.dtype.name, np.ascontiguousarray(obj).tobytes()])
        return b"\xc9" + struct.pack(">I", len(body)) + b"\x01" + body
    raise TypeError(type(obj))


def flax_restore_phase(tmp: Path, db: Path) -> dict:
    """A SchNet TrainState (configs/schnet.yaml width, seeded weights; an
    AdamW chain state and no EMA) written as flax's msgpack, restored by
    `job_type: test` with ``ckpt_path``: E and F once per interaction and
    test batch, and every metric equal (FLAX_METRIC_RTOL) to those of the
    same weights carried in with `params`."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.models.convert import flax_params_of

    cfg = dict(smoke_config(str(db), "", str(tmp), config="schnet"), job_type="test")
    seeded = dict(cfg, trainer=dict(cfg["trainer"], seed=SEED + 6))  # not the job's own init
    params = flax_params_of(pipelines.build_model(seeded, torch.device("cpu")))

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}

    adam = {"count": np.array(3, np.int32), "mu": zeros(params), "nu": zeros(params)}
    state = {"step": np.array(3, np.int32), "params": params,
             "opt_state": {"0": {}, "1": {"count": np.array(3, np.int32),
                                          "hyperparams": {"learning_rate": np.array(1e-4,
                                                                                    np.float32)},
                                          "hyperparams_states": {},
                                          "inner_state": {"0": adam, "1": {"inner_state": {}},
                                                          "2": {}}}},
             "ema_params": None}
    path = tmp / "schnet_flax.ckpt"
    path.write_bytes(_msgpack(state))

    dm = pipelines.build_datamodule(cfg)
    n_test, n_layers = len(dm.test_dataloader()), cfg["model"]["kwargs"]["n_interactions"]
    # the main path: counts reset just before, read just after
    reset_all_launches()
    restored = pipelines.run(dict(cfg, ckpt_path=str(path)))
    torch.cuda.synchronize()
    launches = all_launches()
    want = _want(launches, schnet_fwd=n_layers * n_test, schnet_bwd=n_layers * n_test)
    check(launches == want, f"flax restore launches {launches}, expected {want}")
    carried = pipelines.run(cfg, params=params)
    check(set(restored) == set(carried) and all(
        abs(restored[k] - carried[k]) <= FLAX_METRIC_RTOL * abs(carried[k]) for k in carried),
        f"test metrics from the flax file {restored} vs the same params {carried}")
    emit("flax_restore", config="schnet", checkpoint_bytes=path.stat().st_size,
         test_batches=n_test, launches=launches, test_from_file=restored,
         test_from_params=carried, tolerances={"metric_rel": FLAX_METRIC_RTOL})
    return launches


# ---------------------------------------------------------------------------
# bf16 compute: PaiNN and SchNet through A-D's and E-H's bf16 mode; DimeNet++
# and Graphormer3D
# ---------------------------------------------------------------------------

# A-D's bf16 mode against their plain versions on the same bf16 inputs on the
# card: both compute in fp32 from the same bf16 values and round once (A and C
# their outputs, B and D in the wrapper; B's g_dist stays fp32), so summing in
# another order may flip that rounding: per element |kernel - plain| <=
# BF16_ULP_REL |plain| + BF16_MAX_REL max |plain|
BF16_ULP_REL, BF16_MAX_REL = 2.0 ** -7, 2e-5
# a bf16 model against the card's fp32 run on the same weights: E within
# BF16_E_VS_F32 x max |E| (the JAX package's bf16 zoo bound,
# tests/models/test_bf16_zoo.py:64-66)
BF16_E_VS_F32 = 0.05
# PaiNN's fused bf16 path against its plain bf16 path on the card, and the
# fused path under a rotation, x the largest magnitude: both paths run the
# bf16 model and round in other places (the kernels in fp32, the plain path
# op by op), ~2^-8 an op over 6 layers; at full width on the CPU, 8
# molecules of <= 32 atoms, the two paths' E lay 0.3 % and F 1.0 % apart,
# and a rotation moved E 0.16 % and F 0.85 %
BF16_PATHS_TOL = {"energy": 2e-2, "forces": 5e-2}
BF16_ROT_TOL = {"energy": 1e-2, "forces": 5e-2}
# PaiNN's bf16 model on trained weights under a rotation. The witness
# tests/painn_bf16_rot_gap.py (the CPU, painn-oc width, weights trained by the
# port's trainer, 10 steps at batch 16, 8 molecules a bucket) saw the JAX
# package's own bf16 PaiNN (`exact_jit`) move E by up to 2.01 % of max |E|
# and the port's plain bf16 path by up to 2.68 %, F by up to 1.44 % and
# 1.42 % of max |F|: the gap is the bf16 model's. E within twice the larger
# reading; F keeps BF16_ROT_TOL's 5e-2, above twice either F reading
BF16_TRAINED_ROT_TOL = {"energy": 5.37e-2, "forces": 5e-2}
# PaiNN's bf16 E against fp32 on trained weights. The JAX package's bf16 Dense
# rounds x @ W before it adds the bias, so a trained bias under half an ulp
# adds nothing and the bf16 model drifts from fp32: the witness saw the JAX
# package's own bf16 PaiNN 4.3-8.7 % of max |E| off its fp32 on CPU-trained
# weights (the port's 4.6-6.6 %), the H100 the port's 6.7-10.04 % on its bf16
# train checkpoint. E within twice the larger reading
BF16_TRAINED_E_VS_F32 = 0.201
# SchNet's bf16 model under a rotation: the rotation moves the roundings of
# every bf16 feature, so it is held as two bf16 evaluations are, E within
# BF16_E_VS_F32 and F within twice the bf16-vs-fp32 F gap seen on the H100
# (3.5 % of max |F| at A=32; E moved 1.7 % of max |E| there)
SCHNET_BF16_ROT_TOL = {"energy": BF16_E_VS_F32, "forces": 1e-1}
# the JAX benchmark's headline row (bench.py:133-134, :331-340): painn-oc width
# with 40 neighbours, 256 molecules of 30-48 atoms, force_grads "pallas"
HEADLINE_BATCH, HEADLINE_ATOMS, HEADLINE_NEIGHBORS, HEADLINE_STEPS = 256, 48, 40, 10
# timed predict passes of the bf16 direct phases after a warm-up pass
BF16_DIRECT_PASSES = 2
# the bf16 mode of the kernel families' kernels and models (FAMILIES), by
# family: "kernels" the kernels line's rows (name, JAX kernel body line,
# launch counter); "args" the inputs of the forward, backward, dual forward
# and dual backward kernels and "pair" the pair tensors their `fwd_work` /
# `bwd_work` count; "no_gw" the rows also run without gW; "fp32" the inputs
# the model hands over in fp32 (SchNet's filter weights); "same_live" whether
# the bf16 inputs keep every live pair of the fp32 ones (SchNet's envelope
# lanes: yes; PaiNN's Gaussian rbf rows of pairs past ~7 Å hold only fp32
# subnormals, which bf16, whose least subnormal is 2^-133, rounds to zero, so
# bf16 may drop such a pair: its count is at most fp32's); the bf16 model's
# limits against fp32 ("e_vs_f32") and under a rotation on the weights the
# predict phase runs (the bf16 train phase's best checkpoint), train epochs
# and timed predict passes
BF16_FAMILIES = {
    "painn": dict(
        kernels={"A": ("painn_fwd (A, bf16)", 114, "painn_fwd_bf16"),
                 "B": ("painn_bwd (B, bf16)", 177, "painn_bwd_bf16"),
                 "C": ("painn_dual_fwd (C, bf16)", 286, "painn_dual_fwd_bf16"),
                 "D": ("painn_dual_bwd (D, bf16)", 372, "painn_dual_bwd_bf16")},
        args=(("rbf", "phi", "v", "unit_t", "w"),
              ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv"), C_ARGS, D_ARGS),
        pair=(("rbf",), ("rbfp",), ("rbfd",), ("rbfd",)), no_gw=("B",), fp32=(),
        same_live=False, inputs=kernel_inputs, e_vs_f32=BF16_TRAINED_E_VS_F32,
        rot_tol=BF16_TRAINED_ROT_TOL, epochs=TRAIN_EPOCHS, passes=PASSES),
    "schnet": dict(
        kernels={"E": ("schnet_fwd (E, bf16)", 76, "schnet_fwd_bf16"),
                 "F": ("schnet_bwd (F, bf16)", 89, "schnet_bwd_bf16"),
                 "G": ("schnet_dual_fwd (G, bf16)", 127, "schnet_dual_fwd_bf16"),
                 "H": ("schnet_dual_bwd (H, bf16)", 154, "schnet_dual_bwd_bf16")},
        args=(E_ARGS, F_ARGS, G_ARGS, H_ARGS),
        pair=(("envf", "envf"), ("envf", "envp"), ("envf", "envfd"), ("envf", "envfd")),
        no_gw=("F", "H"), fp32=("w1", "b1", "w2", "b2"), same_live=True,
        inputs=schnet_kernel_inputs, e_vs_f32=BF16_E_VS_F32,
        rot_tol=SCHNET_BF16_ROT_TOL, epochs=1, passes=BF16_DIRECT_PASSES),
}


class NoPlain:
    """While entered, the named plain versions ((ops module, function)
    pairs) raise: a path that reached one instead of a kernel fails."""

    def __init__(self, names):
        self.names = names

    def __enter__(self):
        import importlib

        self.saved = []
        for module, name in self.names:
            mod = importlib.import_module(f"nabladft_tpu_torch.ops.{module}")
            self.saved.append((mod, name, getattr(mod, name)))

            def refuse(*args, _name=name, **kwargs):
                raise RuntimeError(f"{_name}, a plain version, ran on the main path")

            setattr(mod, name, refuse)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# M-P's plain versions
SO2_PLAIN = (("escn_layer", "escn_fwd_reference"), ("escn_layer", "escn_bwd_reference"),
             ("eqv2_attn", "eqv2_fwd_reference"), ("eqv2_attn", "eqv2_bwd_reference"))
PLAIN_NAMES = ("message_reference", "message_bwd_reference", "dual_fwd_reference",
               "dual_bwd_reference")


def no_plain(family: str) -> NoPlain:
    """A-D's (PaiNN) or E-H's (SchNet) plain versions, as their wrappers
    reach them, refused (the models' use_pallas "off" paths keep their own)."""
    return NoPlain(tuple((FAMILIES[family]["ops"], f"{family}_{n}") for n in PLAIN_NAMES))


def _bf16_cfg(cfg: dict) -> dict:
    """cfg with ``model.kwargs.compute_dtype=bfloat16``."""
    m = cfg["model"]
    return dict(cfg, model=dict(m, kwargs=dict(m["kwargs"], compute_dtype="bfloat16")))


def _f32_cfg(cfg: dict) -> dict:
    m = cfg["model"]
    return dict(cfg, model=dict(m, kwargs={k: v for k, v in m["kwargs"].items()
                                           if k != "compute_dtype"}))


def bf16_compare(got, ref) -> dict:
    """Each output against BF16_ULP_REL |ref| + BF16_MAX_REL max |ref| per
    element: the largest error, its share of the output's largest magnitude
    and the largest share of the limit (<= 1 passes)."""
    errs, scales, shares = [], [], []
    for g, r in zip(got, ref):
        if g is None and r is None:
            continue
        check(g.dtype == r.dtype and g.shape == r.shape, f"dtype / shape {g.dtype} {r.dtype}")
        g, r = g.float(), r.float()
        scale = float(r.abs().max())
        limit = BF16_ULP_REL * r.abs() + BF16_MAX_REL * scale + 1e-30
        diff = (g - r).abs()
        errs.append(float(diff.max()))
        scales.append(scale)
        shares.append(float((diff / limit).max()))
    return {"max_abs_err": max(errs), "max_rel_err": max(e / max(s, 1e-30)
                                                         for e, s in zip(errs, scales)),
            "err_over_limit": max(shares), "per_output_abs_err": errs,
            "per_output_max_abs": scales}


def kernel_bf16_bucket(family: str, mod, dev, a: int, card: str) -> dict:
    """The family's kernels (BF16_FAMILIES) in their bf16 mode at (KB, a, KR,
    KF) on its kernel inputs rounded to bf16 (but those the model hands over
    in fp32), against their plain versions on the same inputs (BF16_ULP_REL /
    BF16_MAX_REL), each twice for the same bits, the "no_gw" rows with and
    without gW; the live pairs those of the fp32 inputs where "same_live"
    (rounding only zeroes values, so equal counts are equal lists), else at
    most theirs; kernel, plain and fp32-kernel (the same kernel on the fp32
    inputs) times, the FMA bound and the TC bound (`_so2_row`, the products
    priced by their operands' dtypes, `tc_bound`) and `stages_ms`."""
    spec = BF16_FAMILIES[family]
    x32 = spec["inputs"](dev, a)
    x = {k: t if k in spec["fp32"] else t.to(torch.bfloat16) for k, t in x32.items()}
    shape = [KB, a, KR, KF]
    wrappers = [getattr(mod, f"{family}_{n}") for n in ("fwd", "bwd", "dual_fwd", "dual_bwd")]
    plains = [getattr(mod, f"{family}_{n}") for n in PLAIN_NAMES]
    specs = {}  # row: (wrapper, plain version, inputs, keywords, its work's pair tensors)
    for key, fn, ref, names, pair in zip(spec["kernels"], wrappers, plains, spec["args"],
                                         spec["pair"]):
        specs[key] = (fn, ref, names, {}, pair)
        if key in spec["no_gw"]:
            specs[f"{key}_no_gw"] = (fn, ref, names, {"need_gw": False}, pair)
    fwd_kinds = tuple(spec["kernels"])[0::2]
    rows = {}
    for key, (fn, ref, names, kw, pair) in specs.items():
        kind, need_gw = key[0], kw.get("need_gw", True)
        args, args32 = [x[k] for k in names], [x32[k] for k in names]

        def call(*t, _fn=fn, _kw=kw):
            out = _fn(*t, **_kw)
            return out if isinstance(out, tuple) else (out,)

        def plain(*t, _ref=ref, _kw=kw):
            out = _ref(*t, **_kw)
            return out if isinstance(out, tuple) else (out,)

        def work_of(t, _kind=kind, _pair=pair, _need_gw=need_gw):
            if _kind in fwd_kinds:
                return mod.fwd_work(_kind, t["rbf"], *(t[n] for n in _pair), KF)
            return mod.bwd_work(_kind, t["rbf"], *(t[n] for n in _pair), KF, need_gw=_need_gw)

        got = call(*args)
        err = bf16_compare(got, plain(*args))
        check(err["err_over_limit"] <= 1.0, f"kernel {key} bf16 error at {shape}: {err}")
        _same_bits(call, args, got, f"kernel {key} bf16 at {shape}")
        del got
        stages = stage_times(call, args)
        t_k = time_ms(lambda: call(*args))
        t_p = time_ms(lambda: plain(*args))
        t_32 = time_ms(lambda: call(*args32))
        work, live32 = work_of(x), work_of(x32)["live_pairs"]
        same = work["live_pairs"] == live32
        check(same or (not spec["same_live"] and work["live_pairs"] < live32),
              f"kernel {key}'s live pairs in bf16 at {shape}: {work}, fp32 {live32}")
        rows[key] = _so2_row(shape, err, t_k, t_p, work, card, fp32_kernel_ms=t_32["median"],
                             live_pairs=work["live_pairs"], live_pairs_fp32=live32,
                             pairs=work["pairs"],
                             bit_identical_rerun=True, stages_ms=stages)
        emit(f"kernel_{key}_bf16", **rows[key],
             tolerance={"ulp_rel": BF16_ULP_REL, "max_rel": BF16_MAX_REL},
             kernel_times=t_k, plain_times=t_p, fp32_kernel_times=t_32)
    return rows


def kernel_bf16_phases(family: str, dev, card: str, ptxas: dict) -> dict:
    """The family's bf16 kernels at every bucket shape; the kernels line's
    rows (numbers at A=HEADLINE_A but max_abs_err, the largest over the
    buckets), the "no_gw" rows with their without-gW times."""
    import importlib

    src = FAMILIES[family]["ops"]
    mod = importlib.import_module(f"nabladft_tpu_torch.ops.{src}")
    per = {}
    for a in BUCKETS:
        for k, row in kernel_bf16_bucket(family, mod, dev, a, card).items():
            per.setdefault(k, []).append(row)
        torch.cuda.empty_cache()
    keep = ("ms", "plain_ms", "fp32_kernel_ms", "bound_ms", "bound_by", "roofline_share",
            "bound_fma_ms", "bound_fma_by", "roofline_share_fma", "flops", "flops_products",
            "flops_other", "bytes", "live_pairs", "pairs", "stages_ms")
    rows = {}
    for k, (name, line, _) in BF16_FAMILIES[family]["kernels"].items():
        head = next(r for r in per[k] if r["shape"][1] == HEADLINE_A)
        rows[f"{k}_bf16"] = dict(
            name=name, route="cuda", dtype="bfloat16", source=f"nabladft_tpu_torch/csrc/{src}.cu",
            replaces=f"nabladft_tpu/ops/pallas/{src}.py:{line}",
            max_abs_err=max(r["max_abs_err"] for r in per[k]), library_ms=None,
            timed_shape=head["shape"], **{f: head[f] for f in keep},
            ptxas=ptxas.get(src, {}),
            per_bucket=[{f: r[f] for f in ("shape", "max_abs_err", "err_over_limit", "ms",
                                            "plain_ms", "fp32_kernel_ms", "bound_ms",
                                            "bound_fma_ms", "live_pairs", "live_pairs_fp32")}
                        for r in per[k]])
        if k in BF16_FAMILIES[family]["no_gw"]:
            ng = next(r for r in per[f"{k}_no_gw"] if r["shape"][1] == HEADLINE_A)
            rows[f"{k}_bf16"].update(
                {f"{f}_without_gw": ng[f] for f in ("ms", "plain_ms", "fp32_kernel_ms",
                                                     "bound_ms", "bound_fma_ms", "stages_ms")},
                max_abs_err_without_gw=max(r["max_abs_err"] for r in per[f"{k}_no_gw"]))
    return rows


def _outputs(model, batch) -> dict:
    from nabladft_tpu_torch.models.base import forward

    return {k: v.float() for k, v in forward(model, batch).items()}


def _rel_err(got: dict, want: dict, key: str) -> float:
    return _max_abs(got[key] - want[key]) / max(_max_abs(want[key]), 1e-30)


def _bf16_vs_f32(models: dict, batches: dict, limit: float = BF16_E_VS_F32) -> list:
    """Per bucket: the bf16 model's E against the fp32 model's on the same
    weights (`limit` x max |E|), F finite; returns the rows."""
    out = []
    for a, batch in sorted(batches.items()):
        o16, o32 = _outputs(models["bf16"], batch), _outputs(models["f32"], batch)
        check(all(bool(torch.isfinite(o16[k]).all()) for k in ("energy", "forces")),
              f"bf16 E and F finite at A={a}")
        e_err = _rel_err(o16, o32, "energy")
        check(e_err <= limit, f"bf16 E at A={a}: {e_err} of max |E| off the fp32 run")
        out.append({"shape": list(batch.z.shape), "energy_rel_err_vs_fp32": e_err,
                    "forces_rel_err_vs_fp32": _rel_err(o16, o32, "forces")})
    return out


def _first_batches(loader, dev) -> dict:
    first = {}
    for batch in loader:
        first.setdefault(batch.z.shape[1], batch.to(dev))
    check(sorted(first) == list(BUCKETS), f"buckets {sorted(first)}")
    return first


def _bf16_counts(family: str, n_layers: int, fwd_calls: int, train_steps: int = 0) -> dict:
    """The family's bf16 launches: the forward and backward kernels once per
    interaction of each forward (train step, validation, test or predict
    batch), the dual ones once per interaction of each train step; the
    backward's gW stage never."""
    fwd, bwd, _, dfwd, dbwd = (f"{c}_bf16" for c in FAMILIES[family]["counters"])
    return {fwd: n_layers * fwd_calls, bwd: n_layers * fwd_calls,
            dfwd: n_layers * train_steps, dbwd: n_layers * train_steps}


# each bf16 train phase's best checkpoint, which its predict phase reads
BF16_BEST: dict = {}


def bf16_train_phase(tmp: Path, db: Path, family: str) -> dict:
    """`job_type: train` (the family's bf16 epochs, force_grads "pallas"),
    then `test`, of its config (configs/painn-oc.yaml, configs/schnet.yaml)
    with compute_dtype bf16 at full width over the seeded DB, the kernels'
    plain versions refused (`no_plain`): the dual kernels in bf16 6 times a
    train step, the forward and backward ones 6 times a train step,
    validation and test batch, the backward's gW stage and every fp32 kernel
    never; finite metrics; mol/s, busy share over two train steps and peak
    memory beside the fp32 path's. Keeps the best checkpoint in BF16_BEST,
    which the predict phase reads."""
    from nabladft_tpu_torch import pipelines

    fam, spec = FAMILIES[family], BF16_FAMILIES[family]
    ckpt, outputs = tmp / f"ckpt_{family}_bf16", tmp / f"outputs_{family}_bf16"
    cfg = _bf16_cfg(train_config(str(db), str(tmp), str(ckpt), str(outputs),
                                 config=fam["config"]))
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=spec["epochs"])
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    with no_plain(family):
        res, test, launches, peak_mem, t_start, best = _train_job(cfg, ckpt)
    BF16_BEST[family] = best
    steps, n_layers = res["step"], cfg["model"]["kwargs"]["n_interactions"]
    want = dict.fromkeys(launches, 0)
    want.update(_bf16_counts(family, n_layers, steps + spec["epochs"] * n_val + n_test, steps))
    check(launches == want, f"{family} bf16 train/test launches {launches}, expected {want}")
    step_rows, rates, epoch_seconds = _train_readings(cfg, res, test, ("energy", "forces"),
                                                      t_start, n_train, spec["epochs"])
    dev = torch.device("cuda")
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None), dev)
    check(trainer._force_grads == "pallas" and trainer.model.cdt == torch.bfloat16
          and trainer.model.use_pallas == "fused", f"{family} bf16 route")
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    busy = profile_steps(f"{family}_bf16_train_profile", trainer._train_step, batches,
                         present=fam["train_present"])
    del trainer
    emit(f"{family}_bf16_train", config=fam["config"], compute_dtype="bfloat16", steps=steps,
         launches=launches, expected_launches=want, final_val=res, test=test,
         train_losses_first_last=[step_rows[0]["train/total"], step_rows[-1]["train/total"]],
         molecules_per_second=dict(_rates(rates, "steps"), epoch=spec["epochs"] - 1),
         seconds_per_epoch=epoch_seconds, device_busy_share=busy,
         peak_device_memory_bytes=peak_mem, fp32=READINGS.get(fam["prefix"] + "train"))
    return launches


def bf16_predict_phase(tmp: Path, db: Path, family: str) -> dict:
    """`job_type: predict` of the family's config with compute_dtype bf16
    from its bf16 train phase's best checkpoint, the kernels' plain versions
    refused: the forward and backward kernels in bf16 6 times a batch, the
    backward's gW stage and every fp32 kernel never; finite rows. On the same
    weights, per bucket: the first batch's E within the family's e_vs_f32 of
    the fp32 model's (F's gap printed), the fused bf16 path against the plain bf16 one
    on the card (BF16_PATHS_TOL) and under a rotation (the family's
    rot_tol); whether cuBLAS's reduced-precision bf16 reduction moves E;
    mol/s, busy share and peak memory beside the fp32 path's."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.train import Trainer

    fam, spec = FAMILIES[family], BF16_FAMILIES[family]
    best = BF16_BEST[family]
    cfg = _bf16_cfg(smoke_config(str(db), str(tmp / f"predictions_{family}_bf16.db"), str(tmp),
                                 config=fam["config"]))
    cfg["ckpt_path"] = str(best)
    # the main path: counts reset just before, read just after
    with no_plain(family):
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        res = pipelines.run(cfg)
        torch.cuda.synchronize()
        launches = all_launches()
        peak_mem = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want.update(_bf16_counts(family, cfg["model"]["kwargs"]["n_interactions"], res["batches"]))
    check(launches == want, f"{family} bf16 predict launches {launches}, expected {want}")
    check(res["rows"] == N_MOLS, f"rows written {res['rows']} != {N_MOLS}")
    for rec in AseDatabase(cfg["output_db"]).select_all():
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite bf16 predictions")

    dev = torch.device("cuda")
    dm = pipelines.build_datamodule(cfg)
    models = {}
    for key, c in (("bf16", cfg), ("plain", _plain_cfg(cfg)), ("f32", _f32_cfg(cfg))):
        t = Trainer(pipelines.build_model(c, dev), dev)
        t.load_checkpoint(best)
        models[key] = t.model.eval()
    check(models["bf16"].use_pallas == "fused" and models["bf16"].cdt == torch.bfloat16
          and models["plain"].use_pallas == "off" and models["plain"].cdt == torch.bfloat16
          and models["f32"].cdt == torch.float32, "model modes")
    first = _first_batches(dm.predict_dataloader(), dev)
    checks = _bf16_vs_f32({"bf16": models["bf16"], "f32": models["f32"]}, first,
                          spec["e_vs_f32"])
    rot = torch.from_numpy(rotation()).to(dev)
    for row, (a, batch) in zip(checks, sorted(first.items())):
        out, out_p = _outputs(models["bf16"], batch), _outputs(models["plain"], batch)
        out_r = _outputs(models["bf16"], batch.replace(pos=batch.pos @ rot.T))
        want_r = {"energy": out["energy"], "forces": out["forces"] @ rot.T}
        for k in ("energy", "forces"):
            row[f"{k}_rel_err_vs_plain_bf16"] = _rel_err(out, out_p, k)
            row[f"{k}_rel_err_rotation"] = _rel_err(out_r, want_r, k)
            check(row[f"{k}_rel_err_vs_plain_bf16"] <= BF16_PATHS_TOL[k],
                  f"{family} fused vs plain bf16 {k} at A={a}: {row}")
            check(row[f"{k}_rel_err_rotation"] <= spec["rot_tol"][k],
                  f"{family} bf16 rotation {k}: {row}")
    # cuBLAS may reduce bf16 GEMMs in bf16 where allowed: the first batch's E
    # with the reduction allowed (off everywhere else in this script)
    batch = first[BUCKETS[0]]
    e_off = _outputs(models["bf16"], batch)["energy"]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        e_on = _outputs(models["bf16"], batch)["energy"]
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    reduced = {"same_bits": bool(torch.equal(e_on, e_off)),
               "energy_max_abs_diff": _max_abs(e_on - e_off)}
    gpu = Trainer(models["bf16"], dev)
    del models
    rates = []
    for p in range(spec["passes"] + 1):
        t0 = time.perf_counter()
        n_pred = sum(len(o["energy"]) for o in gpu.predict(dm.predict_dataloader()))
        torch.cuda.synchronize()
        if p:
            rates.append(n_pred / (time.perf_counter() - t0))
    busy = profile_phase(f"{family}_bf16_profile", gpu, dm, present=fam["predict_present"])
    emit(f"{family}_bf16_predict", config=fam["config"], compute_dtype="bfloat16",
         rows=res["rows"], batches=res["batches"], launches=launches, run_seconds=res["seconds"],
         checks=checks, reduced_precision_reduction=reduced,
         molecules_per_second=_rates(sorted(rates), "passes"), device_busy_share=busy,
         peak_device_memory_bytes=peak_mem, fp32=READINGS.get(fam["prefix"] + "predict"),
         tolerances={"energy_vs_fp32": spec["e_vs_f32"], "vs_plain_bf16": BF16_PATHS_TOL,
                     "rotation": spec["rot_tol"]})
    return launches


def headline_batch(seed: int):
    """bench.py's make_batch: HEADLINE_BATCH molecules of 30-HEADLINE_ATOMS atoms
    (z 1-16, positions uniform in [-5, 5) Å), energy and force targets
    normal."""
    from nabladft_tpu_torch.data.batch import MolBatch

    rng = np.random.default_rng(seed)
    b, a = HEADLINE_BATCH, HEADLINE_ATOMS
    z, pos = np.zeros((b, a), np.int32), np.zeros((b, a, 3), np.float32)
    mask = np.zeros((b, a), bool)
    for i in range(b):
        n = int(rng.integers(30, a + 1))
        z[i, :n], pos[i, :n], mask[i, :n] = rng.integers(1, 17, n), rng.uniform(-5, 5, (n, 3)), True
    forces = rng.normal(size=(b, a, 3)).astype(np.float32) * mask[..., None]
    return MolBatch(z=torch.from_numpy(z), pos=torch.from_numpy(pos),
                    node_mask=torch.from_numpy(mask), graph_mask=torch.ones(b, dtype=torch.bool),
                    energy=torch.from_numpy(rng.normal(size=b).astype(np.float32)),
                    forces=torch.from_numpy(forces), mol_id=torch.arange(b, dtype=torch.int32))


# the JAX benchmark's train rows at bench.py's headline shape: PaiNN's
# (bench.py:331-340) and SchNet's (bench.py:89-98), both force_grads "pallas"
HEADLINE_MODELS = {
    "painn": dict(name="painn", kwargs=dict(hidden=128, n_interactions=6, n_rbf=100, cutoff=5.0),
                  counters=("painn_fwd", "painn_bwd", "painn_dual_fwd", "painn_dual_bwd")),
    "schnet": dict(name="schnet", kwargs=dict(hidden=128, n_interactions=6, n_rbf=100,
                                              cutoff=5.0),
                   counters=("schnet_fwd", "schnet_bwd", "schnet_dual_fwd", "schnet_dual_bwd")),
}


def bf16_headline_phase(family: str) -> dict:
    """HEADLINE_STEPS train steps (after two warm-up steps) at bench.py's
    headline shape in bf16 and in fp32, in that order, on the same weights
    and batch, of PaiNN or SchNet: the step's wall ms (host clock around a
    synchronised step), mol/s, peak memory; the family's four kernels'
    launches (6 each a step) in the dtype's mode; finite losses. No speed
    limit."""
    from nabladft_tpu_torch.models import create_model
    from nabladft_tpu_torch.train import Trainer, TrainerConfig, seeded_generator

    spec = HEADLINE_MODELS[family]
    dev = torch.device("cuda")
    batch = headline_batch(SEED).to(dev)
    out, launches_all = {}, {}
    for dt in ("bfloat16", "float32"):
        model = create_model(spec["name"], device=dev, generator=seeded_generator(SEED),
                             max_neighbors=HEADLINE_NEIGHBORS, use_pallas="fused",
                             compute_dtype=dt, **spec["kwargs"])
        trainer = Trainer(model, dev, TrainerConfig(
            schedule="constant", lr=1e-4, force_grads="pallas", log_every_n_steps=10**9,
            loss_specs={"energy": "l1", "forces": "l2norm"},
            loss_coefs={"energy": 1.0, "forces": 1.0}))
        for _ in range(2):
            trainer._train_step(batch)
        torch.cuda.synchronize()
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(HEADLINE_STEPS):
            t0 = time.perf_counter()
            m = trainer._train_step(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(all(np.isfinite(float(v)) for v in m.values()), f"finite {dt} step {m}")
        launches = all_launches()
        sfx = "_bf16" if dt == "bfloat16" else ""
        want = dict.fromkeys(launches, 0)
        want.update({f"{k}{sfx}": 6 * HEADLINE_STEPS for k in spec["counters"]})
        check(launches == want, f"{family} {dt} headline launches {launches}, expected {want}")
        ms.sort()
        out[dt] = {"step_ms": _rates(ms, "steps"),
                   "molecules_per_second": HEADLINE_BATCH / (ms[len(ms) // 2] / 1e3),
                   "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}
        launches_all = {k: launches_all.get(k, 0) + v for k, v in launches.items()}
        del trainer, model
        torch.cuda.empty_cache()
    emit(f"{family}_bf16_headline", model=spec["name"], shape=[HEADLINE_BATCH, HEADLINE_ATOMS],
         max_neighbors=HEADLINE_NEIGHBORS, steps=HEADLINE_STEPS, bfloat16=out["bfloat16"],
         float32=out["float32"])
    return launches_all


def energy_bf16_phase(tmp: Path, db: Path, family: str) -> dict:
    """One epoch of `job_type: train`, then `test`, then `predict` from its
    best checkpoint, of DimeNet++, Graphormer3D or GemNet-OC (through its
    scale fit at train start) with compute_dtype bf16 at full width over the
    seeded DB: no kernel of A-P; finite metrics and rows; per bucket the best
    checkpoint's E within BF16_E_VS_F32 of the fp32 model's on the same
    weights (eval mode), F finite; GemNet-OC's bf16 scale fit against the
    fp32 phase's (`gemnet_bf16_scales`); train and predict mol/s, peak
    memory."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.train import Trainer

    fam = ENERGY[family]
    ckpt, outputs = tmp / f"ckpt_{family}_bf16", tmp / f"outputs_{family}_bf16"
    cfg = _bf16_cfg(train_config(str(db), str(tmp), str(ckpt), str(outputs),
                                 config=fam["config"]))
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=1)
    dm = pipelines.build_datamodule(cfg)
    res, test, launches, peak_train, t_start, best = _train_job(cfg, ckpt)
    check(res["step"] == len(dm.train_dataloader()), f"{family} bf16: one epoch, {res['step']}")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    check(len(step_rows) == res["step"] and all(
        np.isfinite(r["train/total"]) and r["skipped_nonfinite"] == 0.0 for r in step_rows),
        f"{family} bf16 train rows")
    for m in (res, test):
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    pcfg = dict(_bf16_cfg(smoke_config(str(db), str(tmp / f"predictions_{family}_bf16.db"),
                                       str(tmp), config=fam["config"])), ckpt_path=str(best))
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    pres = pipelines.run(pcfg)
    torch.cuda.synchronize()
    launches = {k: v + launches[k] for k, v in all_launches().items()}
    peak_predict = torch.cuda.max_memory_allocated()
    check(not any(launches.values()), f"{family} bf16 launched kernels of A-P: {launches}")
    check(pres["rows"] == N_MOLS, f"{family} bf16 rows {pres['rows']}")
    for rec in AseDatabase(pcfg["output_db"]).select_all():
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite bf16 predictions")
    dev = torch.device("cuda")
    models = {}
    for key, c in (("bf16", pcfg), ("f32", _f32_cfg(pcfg))):
        t = Trainer(pipelines.build_model(c, dev), dev)
        t.load_checkpoint(best)
        models[key] = t.model.eval()
    check(models["bf16"].cdt == torch.bfloat16 and models["f32"].cdt == torch.float32, "dtypes")
    checks = _bf16_vs_f32(models, _first_batches(dm.predict_dataloader(), dev))
    scales = gemnet_bf16_scales(tmp, best) if family == "gemnet_oc" else None
    rates = sorted(r["mols_per_sec"] for r in step_rows)
    emit(f"{family}_bf16", config=fam["config"], compute_dtype="bfloat16", steps=res["step"],
         launches=launches, final_val=res, test=test, checks=checks, scale_factors=scales,
         predict_rows=pres["rows"],
         predict_run_seconds=pres["seconds"],
         predict_molecules_per_second=pres["rows"] / pres["seconds"],
         train_molecules_per_second=_rates(rates, "steps"),
         peak_device_memory_bytes={"train": peak_train, "predict": peak_predict})
    return launches


# M-P's bf16 mode (mxu_bf16) against their plain versions in that mode on the
# same inputs on the card: both round the same products' operands to bf16 and
# sum in fp32, in another order, which may flip a value's rounding by one bf16
# ulp; a later rounding stage turns the flips' differences into more flips, so
# a kernel of several stages (P: conv 2's transpose, conv 1's, the radial
# product's, the rounded per-edge rows summed into gx) carries them far. Per
# output, the relative Frobenius error <= BF16_SO2_FRO_REL and the largest
# error <= BF16_SO2_MAX_REL x max |plain|. On the H100 (tools/so2_bf16_errors.py,
# B=2 and 64 at A=32/48): the kernels' Frobenius errors 1.4e-5 to 1.1e-3 (P's
# gx, gxe, w_rad), the two plain versions on the card and the CPU 1.3e-5 to
# 5.9e-4 apart, the fp32 kernels 2.8e-3 to 1.2e-2 off (a rounding point missed
# or added lands there); the largest errors <= 3.2e-3 (P's gx; the two plain
# versions 6.5e-3 apart there).
BF16_SO2_FRO_REL, BF16_SO2_MAX_REL = 2e-3, 2.0 ** -5
# M-P's bf16 rows: (name, TPU kernel's module, JAX kernel body line, launch counter)
SO2_BF16_KERNELS = {
    "M": ("escn_fwd (M, bf16)", "escn_layer", 385, "escn_fwd_bf16"),
    "N": ("escn_bwd (N, bf16)", "escn_layer", 398, "escn_bwd_bf16"),
    "O": ("eqv2_fwd (O, bf16)", "eqv2_attn", 640, "eqv2_fwd_bf16"),
    "P": ("eqv2_bwd (P, bf16)", "eqv2_attn", 741, "eqv2_bwd_bf16"),
}


def fro_rel(got, ref) -> float:
    """The relative Frobenius error of got against ref."""
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm().clamp_min(1e-30))


def so2_bf16_kernel_phases(dev, card: str, ptxas: dict) -> dict:
    """Kernels M, N, O and P in their bf16 mode at every bucket shape of the
    eSCN and EquiformerV2 paths (B=BATCH, the fp32 kernel phases' inputs, O
    and P with the seeded keep mask), each against its plain version in the
    same mode (run ESCN_PLAIN_MOLS / EQV2_PLAIN_MOLS molecules at a time;
    BF16_SO2_FRO_REL and BF16_SO2_MAX_REL, every cotangent of N and P), each
    twice for the same bits; the fp32 kernel on the same inputs, its distance
    from the plain bf16 version printed (the roundings' own size). At A=HEADLINE_A: kernel,
    fp32-kernel and plain times and the bounds (`tc_bound` with the products
    at the dense bf16 rate; the FMA bound all at the fp32 rate). Returns the
    kernels line's rows."""
    from nabladft_tpu_torch.ops import eqv2_attn as ea
    from nabladft_tpu_torch.ops import escn_layer as el

    as_tuple = (lambda t: t if isinstance(t, tuple) else (t,))
    per = {k: [] for k in SO2_BF16_KERNELS}
    for a in BUCKETS:
        shape = [BATCH, a, ESCN_KW["sphere_channels"]]
        x = escn_kernel_inputs(dev, BATCH, a, seed=SEED + 3000 + a)
        inp = eqv2_kernel_inputs(dev, BATCH, a, seed=SEED + 4000 + a, drop=True)
        e_args, o_args = (x["x"], x["d"], x["xe"], *x["ws"]), tuple(_eqv2_args(inp))
        e_dims, o_dims = x["dims"], dict(inp["dims"], mxu_bf16=False)
        specs = {  # kernel: (wrapper, plain version, args, per-molecule args, dims, cotangent,
            #                  plain molecules per call, work)
            "M": (el.escn_fwd, el.escn_fwd_reference, e_args, 3, e_dims, None, ESCN_PLAIN_MOLS,
                  lambda kw: el.flops_bytes("M", x["x"], x["d"], x["xe"], x["ws"], **kw)),
            "N": (el.escn_bwd, el.escn_bwd_reference, e_args, 3, e_dims, x["g"], ESCN_PLAIN_MOLS,
                  lambda kw: el.flops_bytes("N", x["x"], x["d"], x["xe"], x["ws"], **kw)),
            "O": (ea.eqv2_fwd, ea.eqv2_fwd_reference, o_args, 7, o_dims, None, EQV2_PLAIN_MOLS,
                  lambda kw: ea.flops_bytes("O", inp["x"], inp["idx"], inp["d"], inp["xe"],
                                            inp["maskf"], inp["dropk"], inp["ws"], **kw)),
            "P": (ea.eqv2_bwd, ea.eqv2_bwd_reference, o_args, 7, o_dims, inp["g"],
                  EQV2_PLAIN_MOLS,
                  lambda kw: ea.flops_bytes("P", inp["x"], inp["idx"], inp["d"], inp["xe"],
                                            inp["maskf"], inp["dropk"], inp["ws"], **kw)),
        }
        for k, (fn, ref, args, n_mol, dims, g, n_plain, work_of) in specs.items():
            kw16, kw32 = dict(dims, mxu_bf16=True), dict(dims, mxu_bf16=False)
            if g is not None:
                kw16["g"] = kw32["g"] = g

            def call(kw, fn=fn, args=args):
                return as_tuple(fn(*args, **kw))

            def plain(ref=ref, args=args, n_mol=n_mol, kw16=kw16, n_plain=n_plain):
                return as_tuple(_plain_in_chunks(ref, args, n_mol, kw16, n_plain))

            got, want = call(kw16), plain()
            err = compare(got, want)
            err["fro_rel_err"] = max(fro_rel(p_, q_) for p_, q_ in zip(got, want))
            check(err["fro_rel_err"] <= BF16_SO2_FRO_REL and err["max_rel_err"] <= BF16_SO2_MAX_REL,
                  f"kernel {k} bf16 error at {shape}: {err}")
            check(all(torch.equal(p_, q_) for p_, q_ in zip(got, call(kw16))),
                  f"kernel {k} bf16 gives the same bits on a rerun at {shape}")
            got32 = call(kw32)
            fp32_gap = {"max_rel_err": compare(got32, want)["max_rel_err"],
                        "fro_rel_err": min(fro_rel(p_, q_) for p_, q_ in zip(got32, want))}
            del got, got32, want
            torch.cuda.empty_cache()
            row = dict(shape=shape, **err, fp32_kernel_vs_plain_bf16=fp32_gap,
                       bit_identical_rerun=True)
            if a == HEADLINE_A:
                row["stages_ms"] = stage_times(call, (kw16,))
                if k in "OP":
                    row["steps_ms"] = step_times(call, (kw16,), EQV2_STEPS)
                t_k = time_ms(lambda: call(kw16))
                t_32 = time_ms(lambda: call(kw32))
                t_p = time_ms(plain, PLAIN_RUNS, 1)
                work = work_of({q: v for q, v in kw16.items() if q != "g"})
                peak_flops, peak_bw, peak_tf32 = peaks(card, tensor_cores=True)
                b_ms, b_by = tc_bound(work, peak_flops, peak_bw, peak_tf32, bf16_peak(card))
                b_fma, b_fma_by = bound(work["flops_live"], work["bytes"], peak_flops, peak_bw)
                row.update(ms=t_k["median"], plain_ms=t_p["median"],
                           fp32_kernel_ms=t_32["median"], bound_ms=b_ms, bound_by=b_by,
                           roofline_share=b_ms / t_k["median"], bound_fma_ms=b_fma,
                           bound_fma_by=b_fma_by, flops=work["flops_live"],
                           flops_products=work["flops_live_products"],
                           flops_other=work["flops_live_other"], bytes=work["bytes"],
                           kernel_times=t_k, fp32_kernel_times=t_32, plain_times=t_p)
            emit(f"kernel_{k}_bf16", **row,
                 tolerance={"fro_rel": BF16_SO2_FRO_REL, "max_rel": BF16_SO2_MAX_REL},
                 plain_molecules_per_call=n_plain)
            per[k].append(row)
        del x, inp, e_args, o_args, specs
        torch.cuda.empty_cache()
    keep = ("ms", "plain_ms", "fp32_kernel_ms", "bound_ms", "bound_by", "roofline_share",
            "bound_fma_ms", "bound_fma_by", "flops", "flops_products", "flops_other", "bytes",
            "stages_ms")
    rows = {}
    for k, (name, src, line, _) in SO2_BF16_KERNELS.items():
        head = next(r for r in per[k] if r["shape"][1] == HEADLINE_A)
        rows[f"{k}_bf16"] = dict(
            name=name, route="cuda", dtype="bfloat16", source=f"nabladft_tpu_torch/csrc/{src}.cu",
            replaces=f"nabladft_tpu/ops/pallas/{src}.py:{line}",
            max_abs_err=max(r["max_abs_err"] for r in per[k]), library_ms=None,
            timed_shape=head["shape"], **{f: head[f] for f in keep}, ptxas=ptxas.get(src, {}),
            **({"steps_ms": head["steps_ms"]} if "steps_ms" in head else {}),
            per_bucket=[{f: r[f] for f in ("shape", "max_abs_err", "max_rel_err", "fro_rel_err",
                                            "fp32_kernel_vs_plain_bf16")}
                        for r in per[k]])
    return rows


def direct_bf16_phase(tmp: Path, db: Path, family: str) -> dict:
    """eSCN or EquiformerV2 with compute_dtype bf16 at full width and depth
    over the seeded DB: one epoch of `job_type: train`, then `test` and
    `predict` from its best checkpoint, M-P's plain versions refused
    (`NoPlain`): the bf16 forward kernel once per message / attention call
    of each train step, validation, test and predict batch, the bf16 backward
    once per call of each train step, every other kernel of A-P never;
    dropout drawn on train steps only (EquiformerV2); finite metrics and
    rows. Then, eval mode, on the best checkpoint's weights, per bucket: E
    within BF16_E_VS_F32 of the fp32 model's, the fused bf16 model against
    the plain bf16 one on the card (BF16_PATHS_TOL: the two round at the same
    points, but each bf16 stage turns the other's sum-order differences into
    flipped roundings, so EquiformerV2's grid FFNs and attentions carry them
    to the bf16 noise level, that of the bf16-vs-fp32 gap) and E under a
    rotation (the family's limit or BF16_ROT_TOL, the larger); profiles of
    two predict and two train steps (the engine's kernels present: O and P's
    bf16 operand mode, M and N's float32 engine, the other's absent; M-P's
    bf16 launches counted); train and predict mol/s, busy shares and peak
    memory beside the fp32 phases'."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.train import Trainer

    fam = DIRECT[family]
    fwd, bwd = (SO2_BF16_KERNELS[k][3] for k in (("M", "N") if family == "escn" else ("O", "P")))
    ckpt, outputs = tmp / f"ckpt_{family}_bf16", tmp / f"outputs_{family}_bf16"
    cfg = _bf16_cfg(train_config(str(db), str(tmp), str(ckpt), str(outputs),
                                 config=fam["config"]))
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=1)
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    n_layers = cfg["model"]["kwargs"]["num_layers"]
    n_calls = fam["calls"](cfg["model"]["kwargs"])
    pcfg = _bf16_cfg(smoke_config(str(db), str(tmp / f"predictions_{family}_bf16.db"), str(tmp),
                                  config=fam["config"]))

    # the main paths: counts reset just before each, read just after
    with NoPlain(SO2_PLAIN), DropoutDraws() as draws:
        res, test, launches, peak_train, _, best = _train_job(cfg, ckpt)
        draws_train = dict(draws)
        pcfg["ckpt_path"] = str(best)
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        pres = pipelines.run(pcfg)
        torch.cuda.synchronize()
        launches_p = all_launches()
        peak_predict = torch.cuda.max_memory_allocated()
    steps = res["step"]
    check(steps == n_train, f"{family} bf16: one epoch, {steps} steps, expected {n_train}")
    want = dict.fromkeys(launches, 0)
    want.update({fwd: n_calls * (steps + n_val + n_test), bwd: n_calls * steps})
    check(launches == want, f"{family} bf16 train/test launches {launches}, expected {want}")
    want_p = dict.fromkeys(launches_p, 0)
    want_p[fwd] = n_calls * pres["batches"]
    check(launches_p == want_p, f"{family} bf16 predict launches {launches_p}, expected {want_p}")
    want_draws = ({"alpha": n_calls * steps, "drop_path": 2 * n_layers * steps}
                  if fam["dropout"] else {"alpha": 0, "drop_path": 0})
    check(draws_train == draws == want_draws,
          f"{family} bf16 dropout draws {draws_train} (train), {draws} (after predict)")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    check(len(step_rows) == steps and all(
        np.isfinite(r["train/total"]) and r["skipped_nonfinite"] == 0.0 for r in step_rows),
        f"{family} bf16 train rows")
    for m in (res, test):
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check(pres["rows"] == N_MOLS, f"{family} bf16 predict rows {pres['rows']}")
    for rec in AseDatabase(pcfg["output_db"]).select_all():
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite bf16 predictions")

    dev = torch.device("cuda")
    models = {}
    for key, c in (("bf16", pcfg), ("plain", _plain_cfg(pcfg)), ("f32", _f32_cfg(pcfg))):
        t = Trainer(pipelines.build_model(c, dev), dev)
        t.load_checkpoint(best)
        models[key] = t.model.eval()
    check(models["bf16"].cdt == models["plain"].cdt == torch.bfloat16
          and models["f32"].cdt == torch.float32 and models["bf16"].use_pallas == "fused"
          and models["plain"].use_pallas == "off", "model modes")
    first = _first_batches(dm.predict_dataloader(), dev)
    checks = _bf16_vs_f32({"bf16": models["bf16"], "f32": models["f32"]}, first)
    rot = torch.from_numpy(rotation()).to(dev)
    e_rot_tol = max(fam["e_rot"], BF16_ROT_TOL["energy"])
    for row, (a, batch) in zip(checks, sorted(first.items())):
        out = _outputs(models["bf16"], batch)
        out_p = _forward_in_chunks(models["plain"], batch, fam["plain_mols"])
        out_r = _outputs(models["bf16"], batch.replace(pos=batch.pos @ rot.T))
        for k in ("energy", "forces"):
            row[f"{k}_rel_err_vs_plain_bf16"] = _rel_err(out, out_p, k)
            check(row[f"{k}_rel_err_vs_plain_bf16"] <= BF16_PATHS_TOL[k],
                  f"{family} fused vs plain bf16 {k} at A={a}: {row}")
        row["energy_rel_err_rotation"] = _rel_err(out_r, out, "energy")
        row["forces_rel_err_rotation"] = _rel_err(out_r, {"forces": out["forces"] @ rot.T},
                                                  "forces")
        check(row["energy_rel_err_rotation"] <= e_rot_tol, f"{family} bf16 rotation: {row}")
        del out, out_p, out_r
    del models
    torch.cuda.empty_cache()

    gpu = Trainer(pipelines.build_model(pcfg, dev).eval(), dev)
    gpu.load_checkpoint(best)
    rates = []
    for p in range(BF16_DIRECT_PASSES + 1):
        t0 = time.perf_counter()
        n_pred = sum(len(o["energy"]) for o in gpu.predict(dm.predict_dataloader()))
        torch.cuda.synchronize()
        if p:
            rates.append(n_pred / (time.perf_counter() - t0))
    rates.sort()
    # EquiformerV2's O and P run the engine's bf16 operand mode, eSCN's M and N its rbf16
    engine = (("so2_mma16_kernel", "so2_mmw16_kernel") if family == "eqv2"
              else ("so2_mma_kernel", "so2_mmw_kernel"))
    other = (("so2_mma_kernel", "so2_mmw_kernel") if family == "eqv2"
             else ("so2_mma16_kernel", "so2_mmw16_kernel"))
    reset_all_launches()
    busy = profile_steps(f"{family}_bf16_profile", gpu._predict_step,
                         list(itertools.islice(dm.predict_dataloader(), 2)),
                         present=engine[:1], absent=other)
    prof_p = all_launches()
    check(prof_p == {**dict.fromkeys(prof_p, 0), fwd: 2 * n_calls},
          f"{family} bf16 profiled predict launches {prof_p}")
    del gpu
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None), dev)
    batches = list(itertools.islice(dm.train_dataloader(), 2))
    reset_all_launches()
    busy_train = profile_steps(f"{family}_bf16_train_profile", trainer._train_step, batches,
                               present=engine, absent=other)
    prof_t = all_launches()
    check(prof_t == {**dict.fromkeys(prof_t, 0), fwd: 2 * n_calls, bwd: 2 * n_calls},
          f"{family} bf16 profiled train launches {prof_t}")
    del trainer
    torch.cuda.empty_cache()
    emit(f"{family}_bf16", config=fam["config"], compute_dtype="bfloat16", steps=steps,
         launches={"train_test": launches, "predict": launches_p},
         profiled_launches={"predict_2_steps": {fwd: prof_p[fwd]},
                            "train_2_steps": {fwd: prof_t[fwd], bwd: prof_t[bwd]}},
         dropout_draws=draws, final_val=res, test=test, checks=checks,
         predict_rows=pres["rows"], predict_run_seconds=pres["seconds"],
         predict_molecules_per_second=_rates(rates, "passes"),
         train_molecules_per_second=_rates(sorted(r["mols_per_sec"] for r in step_rows),
                                           "steps"),
         device_busy_share={"predict": busy, "train": busy_train},
         peak_device_memory_bytes={"train": peak_train, "predict": peak_predict},
         fp32={"predict": READINGS.get(f"{family}_predict"),
               "train": READINGS.get(f"{family}_train")},
         tolerances={"energy_vs_fp32": BF16_E_VS_F32, "vs_plain_bf16": BF16_PATHS_TOL,
                     "rotation_energy": e_rot_tol})
    return {k: v + launches_p[k] for k, v in launches.items()}


# ---------------------------------------------------------------------------
# bf16 compute, continued: GemNet-OC and EquiformerV2's reference variant
# (no kernel)
# ---------------------------------------------------------------------------

# GemNet-OC's scale factors fitted in bf16 at train start against the fp32
# train phase's fit of the same batches: each within GEMNET_BF16_FIT_RTOL of
# it (the fit's variances are taken in fp32 from bf16 activations, which
# carry bf16's 2^-8 rounding through the blocks; the CPU test at small width,
# tests/test_torch_gemnet_oc.py, holds the bf16 fit to JAX's)
GEMNET_BF16_FIT_RTOL = 5e-2


def gemnet_bf16_scales(tmp: Path, best: Path) -> dict:
    """The bf16 GemNet-OC checkpoint's fitted scales against the fp32 train
    phase's (`energy_train_phase`, the same seeded batches)."""
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)["model"]  # noqa: E731
    b16, f32 = load(best), load(tmp / "ckpt_gemnet_oc" / "last.ckpt")
    names = sorted(n for n in f32 if n.rsplit(".", 1)[-1].startswith("scale_"))
    check(names and all(n in b16 for n in names), "scale factors in both checkpoints")
    rel = {n: abs(b16[n].item() / f32[n].item() - 1.0) for n in names}
    check(all(np.isfinite(b16[n].item()) and b16[n].item() != 1.0 for n in names),
          "every scale fitted in bf16")
    check(max(rel.values()) <= GEMNET_BF16_FIT_RTOL,
          f"bf16 scale fit vs fp32: {max(rel.values())} > {GEMNET_BF16_FIT_RTOL}")
    return {"n_scales": len(names), "bf16_vs_fp32_max_rel": max(rel.values()),
            "bf16": {n: b16[n].item() for n in names}}


# EquiformerV2's reference variant (EQV2_REF_KW) in bf16: configs/equiformer_v2.yaml's
# widths with the depth cut to EQV2_REF_BF16_LAYERS blocks and batch EQV2_REF_BF16_BATCH
# (a plain PyTorch path: its autograd keeps every edge tensor of every block)
EQV2_REF_BF16_LAYERS, EQV2_REF_BF16_BATCH = 4, 16
# its bf16 E against the fp32 model's on the same weights, x max |E|. The
# gap is the variant's own in bf16: at these widths and depth the JAX
# package's XLA path puts its bf16 E 1.4-3.5 % and F 17-32 % of max off its
# fp32 run, the port 1.7-3.1 % and 17-33 % on the same seeded weights and
# molecules (tests/eqv2_ref_bf16_gap.py, on the CPU; F grows with the
# molecules' size). On the H100, after one epoch, E lay 2.6-11.9 % off
# (F 15-29 %) over the buckets of two runs; the limit is twice the largest
# (tests/test_torch_eqv2_bf16.py holds the variant to the JAX model's
# rounding points at small width, E and F within 1e-4)
EQV2_REF_BF16_E_VS_F32 = 0.25


def eqv2_ref_bf16_phase(tmp: Path, db: Path) -> dict:
    """EquiformerV2's reference-compatible variant (m_share_rad False, 600
    Gaussians: the published checkpoints') with compute_dtype bf16: one epoch
    of `job_type: train`, then `test` and `predict` from its best checkpoint
    over the seeded DB: O and P (and every kernel of A-P) never launch;
    finite metrics and rows; per bucket the best checkpoint's E within
    EQV2_REF_BF16_E_VS_F32 of the fp32 model's on the same weights (eval
    mode); train and predict mol/s, peak memory."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.data.ase_codec import AseDatabase
    from nabladft_tpu_torch.train import Trainer

    def ref(cfg):
        m = cfg["model"]
        cfg = dict(cfg, model=dict(m, kwargs=dict(m["kwargs"], **EQV2_REF_KW,
                                                  num_layers=EQV2_REF_BF16_LAYERS)))
        cfg["datamodule"] = dict(cfg["datamodule"], batch_size=EQV2_REF_BF16_BATCH)
        return _bf16_cfg(cfg)

    ckpt, outputs = tmp / "ckpt_eqv2_ref_bf16", tmp / "outputs_eqv2_ref_bf16"
    cfg = ref(train_config(str(db), str(tmp), str(ckpt), str(outputs), config="equiformer_v2"))
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=1)
    dm = pipelines.build_datamodule(cfg)
    res, test, launches, peak_train, _, best = _train_job(cfg, ckpt)
    check(res["step"] == len(dm.train_dataloader()), f"eqv2 ref bf16: one epoch, {res['step']}")
    rows = read_csv(outputs / cfg["name"] / "metrics.csv")
    step_rows = [r for r in rows if "train/total" in r]
    check(len(step_rows) == res["step"] and all(
        np.isfinite(r["train/total"]) and r["skipped_nonfinite"] == 0.0 for r in step_rows),
        "eqv2 ref bf16 train rows")
    for m in (res, test):
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics {m}")
    pcfg = dict(ref(smoke_config(str(db), str(tmp / "predictions_eqv2_ref_bf16.db"), str(tmp),
                                 config="equiformer_v2")), ckpt_path=str(best))
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    pres = pipelines.run(pcfg)
    torch.cuda.synchronize()
    launches = {k: v + launches[k] for k, v in all_launches().items()}
    peak_predict = torch.cuda.max_memory_allocated()
    check(not any(launches.values()), f"eqv2 ref bf16 launched kernels of A-P: {launches}")
    check(pres["rows"] == N_MOLS, f"eqv2 ref bf16 rows {pres['rows']}")
    for rec in AseDatabase(pcfg["output_db"]).select_all():
        e, f = np.asarray(rec.data["energy_pred"]), np.asarray(rec.data["forces_pred"])
        check(bool(np.isfinite(e).all() and np.isfinite(f).all()), "finite bf16 predictions")
    dev = torch.device("cuda")
    models = {}
    for key, c in (("bf16", pcfg), ("f32", _f32_cfg(pcfg))):
        t = Trainer(pipelines.build_model(c, dev), dev)
        t.load_checkpoint(best)
        models[key] = t.model.eval()
    check(models["bf16"].cdt == torch.bfloat16 and models["f32"].cdt == torch.float32
          and not models["bf16"].m_share_rad and models["bf16"].use_pallas == "off", "model modes")
    checks = _bf16_vs_f32(models, _first_batches(dm.predict_dataloader(), dev),
                          EQV2_REF_BF16_E_VS_F32)
    del models
    torch.cuda.empty_cache()
    emit("eqv2_ref_bf16", config="equiformer_v2", compute_dtype="bfloat16",
         model_kwargs=dict(EQV2_REF_KW, num_layers=EQV2_REF_BF16_LAYERS),
         batch_size=EQV2_REF_BF16_BATCH, steps=res["step"], launches=launches, final_val=res,
         test=test, checks=checks, predict_rows=pres["rows"],
         predict_run_seconds=pres["seconds"],
         predict_molecules_per_second=pres["rows"] / pres["seconds"],
         train_molecules_per_second=_rates(sorted(r["mols_per_sec"] for r in step_rows),
                                           "steps"),
         peak_device_memory_bytes={"train": peak_train, "predict": peak_predict})
    return launches


# data parallelism: DP_STEPS train steps of the global batch; the two-rank
# run against one process: the first step's gradients within DP_GRAD_RTOL x
# max |g| per tensor (sums over the ranks in another order), the test
# metrics within DP_METRIC_RTOL relative; the one-rank nccl run against
# painn_train's within DP_NCCL1_RTOL relative (the same program: a world of
# one runs no collective)
DP_STEPS, DP_GRAD_RTOL, DP_METRIC_RTOL, DP_NCCL1_RTOL = 3, 1e-5, 1e-5, 1e-5
DP_MAX_CARDS = 4
DP_TIMEOUT = 300  # s, the ranks of one phase


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rel_gap(got: dict, want: dict) -> float:
    """The largest relative gap of the numbers two metric dicts share."""
    keys = sorted(set(got) & set(want))
    check(bool(keys), f"metrics to compare: {sorted(got)} vs {sorted(want)}")
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in keys)


def _painn_counts(n_layers: int, steps: int, evals: int) -> dict:
    """A-D's launch counts of `steps` train steps and `evals` validation,
    test and predict batches; B's gW stage never, every other kernel never."""
    want = dict.fromkeys(all_launches(), 0)
    want.update(painn_fwd=n_layers * (steps + evals), painn_bwd=n_layers * (steps + evals),
                painn_dual_fwd=n_layers * steps, painn_dual_bwd=n_layers * steps)
    return want


def dp_nccl1_phase(tmp: Path, db: Path) -> dict:
    """One rank from a launcher's environment through `pipelines.run`, on
    nccl (see the module docstring); returns the launch counts."""
    import os

    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.parallel import dist

    ckpt, outputs = tmp / "ckpt_dp_nccl1", tmp / "outputs_dp_nccl1"
    cfg = train_config(str(db), str(tmp), str(ckpt), str(outputs))
    dm = pipelines.build_datamodule(cfg)
    n_train, n_val, n_test = (len(dm.train_dataloader()), len(dm.val_dataloader()),
                              len(dm.test_dataloader()))
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in env}
    groups = []
    init = dist.init_from_env

    def seen(device):  # the group each run starts
        started = init(device)
        groups.append((started, torch.distributed.get_backend() if started else None,
                       dist.world_size(), str(torch.cuda.current_device())))
        return started

    os.environ.update(env)
    dist.init_from_env = seen
    try:
        reset_all_launches()
        res = pipelines.run(cfg)
        best = json.loads((ckpt / "index.json").read_text())["best"][0]["path"]
        test = pipelines.run(dict(cfg, job_type="test", ckpt_path=str(ckpt / best)))
        pred = pipelines.run(dict(cfg, job_type="predict", ckpt_path=str(ckpt / best),
                                  output_db=str(tmp / "dp_nccl1.db")))
        torch.cuda.synchronize()
        launches = all_launches()
    finally:
        dist.init_from_env = init
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(groups == [(True, "nccl", 1, "0")] * 3, f"an nccl group of one per job: {groups}")
    check(not dist.is_initialized(), "each job tore down the group it started")
    one = ONE_PROCESS["painn"]
    check(res["step"] == one["res"]["step"] == TRAIN_EPOCHS * n_train,
          f"steps {res['step']} vs {one['res']['step']}")
    gaps = {"val": _rel_gap(res, one["res"]), "test": _rel_gap(test, one["test"])}
    check(max(gaps.values()) <= DP_NCCL1_RTOL, f"nccl1 against painn_train: {gaps}")
    check(pred["rows"] == N_MOLS, f"predict rows {pred}")
    n_layers = cfg["model"]["kwargs"]["n_interactions"]
    want = _painn_counts(n_layers, res["step"], TRAIN_EPOCHS * n_val + 2 * n_test)
    check(launches == want, f"nccl1 launches {launches}, expected {want}")
    emit("painn_dp_nccl1", groups=groups, steps=res["step"], final_val=res, test=test,
         predict_rows=pred["rows"], rel_gap_to_painn_train=gaps,
         bit_equal={"val": res == one["res"], "test": test == one["test"]},
         launches=launches, expected_launches=want)
    return launches


def dp_rank(r: int, world: int, backend: str, store: str, tmp: str, db: str,
            out: str) -> None:
    """One rank of a data-parallel phase (started with `spawn`): the group,
    the first step's gradients of this rank's share of the first global
    batch, then `pipelines.run` of train, test and predict on its card; its
    results pickled to `out`."""
    import datetime
    import pickle

    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = r if backend == "nccl" else 0
    dev = torch.device("cuda", card)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group(backend, init_method=f"file://{store}", rank=r,
                                         world_size=world,
                                         timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    try:
        results = dict(dp_jobs(Path(tmp), Path(db), dev), rank=r, world=dist.world_size(),
                       backend=torch.distributed.get_backend(), card=card)
    finally:
        torch.distributed.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


def dp_config(tmp: Path, db: Path, tag: str) -> dict:
    cfg = train_config(str(db), str(tmp), str(tmp / f"ckpt_{tag}"), str(tmp / f"outputs_{tag}"))
    cfg["trainer"] = dict(cfg["trainer"], max_epochs=1, max_steps=DP_STEPS)
    return dict(cfg, output_db=str(tmp / f"{tag}.db"))


def dp_jobs(tmp: Path, db: Path, dev: torch.device) -> dict:
    """The data-parallel phases' work in one process of any world: the first
    step's gradients (`Trainer._step_grads` of this rank's share), then
    train, test and predict; A-D's counts over all of it."""
    from nabladft_tpu_torch import pipelines
    from nabladft_tpu_torch.parallel import dist

    tag = "dp" if dist.world_size() > 1 else "dp_one"
    cfg = dp_config(tmp, db, tag)
    reset_all_launches()
    trainer = pipelines.build_trainer(dict(cfg, log_csv=False, ckpt_dir=None), dev)
    dm = pipelines.build_datamodule(cfg)
    first = next(iter(dm.train_dataloader()))
    trainer._step_grads(dist.shard_batch(first).to(dev))
    grads = {n: p.grad.cpu().numpy() for n, p in trainer.model.named_parameters()}
    t0 = time.perf_counter()
    res = pipelines.run(cfg, device=dev)
    t_train = time.perf_counter() - t0
    last = str(Path(cfg["ckpt_dir"]) / "last.ckpt")
    test = pipelines.run(dict(cfg, job_type="test", ckpt_path=last), device=dev)
    pred = pipelines.run(dict(cfg, job_type="predict", ckpt_path=last), device=dev)
    torch.cuda.synchronize(dev)
    return dict(grads=grads, res=res, test=test, pred=pred, launches=all_launches(),
                train_seconds=t_train, output_db=cfg["output_db"], ckpt_dir=cfg["ckpt_dir"],
                first_batch=list(first.z.shape), n_val=len(dm.val_dataloader()),
                n_test=len(dm.test_dataloader()))


def dp_phase(tmp: Path, db: Path, phase: str, backend: str, world: int) -> dict:
    """`world` ranks in a `backend` group against one process on the same
    global batches and weights (see the module docstring); returns the
    ranks' summed launch counts."""
    import multiprocessing
    import pickle

    from nabladft_tpu_torch.data.ase_codec import AseDatabase

    run_dir = tmp / phase
    run_dir.mkdir()
    ctx = multiprocessing.get_context("spawn")
    outs = [run_dir / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=dp_rank, args=(r, world, backend, str(run_dir / "store"),
                                               str(run_dir), str(db), str(outs[r])))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        one = dp_jobs(run_dir, db, torch.device("cuda"))  # one process, meanwhile
    finally:
        for p in procs:
            p.join(timeout=DP_TIMEOUT)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.exitcode == 0 and out.exists(), f"{phase} rank {r} exit code {p.exitcode}")
    ranks = []
    for out in outs:
        with open(out, "rb") as f:
            ranks.append(pickle.load(f))
    check([(x["rank"], x["world"], x["backend"]) for x in ranks]
          == [(r, world, backend) for r in range(world)], f"{phase} groups")
    n_layers = _painn_oc("", "")["model"]["kwargs"]["n_interactions"]
    per_rank = {}
    for x in ranks:
        check(x["res"]["step"] == one["res"]["step"] == DP_STEPS, f"{phase} steps")
        want = _painn_counts(n_layers, DP_STEPS + 1, x["n_val"] + 2 * x["n_test"])
        check(x["launches"] == want,
              f"{phase} rank {x['rank']} launches {x['launches']}, expected {want}")
        per_rank[x["rank"]] = {k: x["launches"][k] for k in
                               ("painn_fwd", "painn_bwd", "painn_dual_fwd", "painn_dual_bwd")}
    grad_err = {}
    for name, g in one["grads"].items():
        scale = max(float(np.abs(g).max()), 1e-30)
        grad_err[name] = max(float(np.abs(x["grads"][name] - g).max()) / scale for x in ranks)
    worst = max(grad_err, key=grad_err.get)
    check(grad_err[worst] <= DP_GRAD_RTOL, f"{phase} first-step gradient {worst}: "
                                           f"{grad_err[worst]:.3e}")
    gaps = {x["rank"]: {"val": _rel_gap(x["res"], one["res"]),
                        "test": _rel_gap(x["test"], one["test"])} for x in ranks}
    check(max(g["test"] for g in gaps.values()) <= DP_METRIC_RTOL, f"{phase} test {gaps}")
    rank0 = ranks[0]
    check(Path(rank0["output_db"]).exists() and (Path(rank0["ckpt_dir"]) / "last.ckpt").exists(),
          f"{phase}: rank 0's files")
    got, want_rows = (list(AseDatabase(x["output_db"]).select_all()) for x in (rank0, one))
    check(len(got) == len(want_rows) == rank0["pred"]["rows"] > 0, f"{phase} rows")
    e_err = f_err = 0.0
    for a, b in zip(got, want_rows):
        check(np.array_equal(a.numbers, b.numbers) and np.array_equal(a.positions, b.positions),
              f"{phase}: the rows in the same order")
        e, e1 = np.asarray(a.data["energy_pred"]), np.asarray(b.data["energy_pred"])
        f, f1 = np.asarray(a.data["forces_pred"]), np.asarray(b.data["forces_pred"])
        check(np.allclose(e, e1, **E_TOL) and np.allclose(f, f1, **F_TOL),
              f"{phase}: E / F of the trained models")
        e_err, f_err = max(e_err, float(np.abs(e - e1).max())), max(f_err,
                                                                    float(np.abs(f - f1).max()))
    mols = DP_STEPS * BATCH
    emit(phase, backend=backend, ranks=world, cards=len({x["card"] for x in ranks}),
         first_batch=rank0["first_batch"], steps=DP_STEPS, test=rank0["test"],
         test_one_process=one["test"], rel_gaps=gaps, grad_max_rel_err=grad_err[worst],
         grad_worst_param=worst, predict_rows=len(got), e_max_abs_err=e_err,
         f_max_abs_err=f_err, launches_by_rank=per_rank, seconds=seconds,
         train_seconds={"ranks": [x["train_seconds"] for x in ranks],
                        "one_process": one["train_seconds"]},
         # the train job's wall time with its validation: correctness, not
         # scaling (gloo's ranks share one card)
         molecules_per_second_train={"ranks": mols / max(x["train_seconds"] for x in ranks),
                                     "one_process": mols / one["train_seconds"]})
    return {k: sum(x["launches"][k] for x in ranks) for k in ranks[0]["launches"]}


def dp_nccl_phase(tmp: Path, db: Path) -> dict:
    """painn_dp_nccl: over min(cards, DP_MAX_CARDS) cards when there are two
    or more; otherwise a line saying it did not run."""
    n = torch.cuda.device_count()
    if n < 2:
        emit("painn_dp_nccl", ran=False, device_count=n,
             reason=f"nccl needs a card a rank; this machine has {n}")
        return dict.fromkeys(all_launches(), 0)
    return dp_phase(tmp, db, "painn_dp_nccl", "nccl", min(n, DP_MAX_CARDS))


# the multi-card dry run (nabladft_tpu_torch/dryrun.py, "full" sizes) against
# one process on the same global batches and weights: the matrix phases' loss
# within DRYRUN_LOSS_RTOL relative, each gradient tensor within
# DRYRUN_GRAD_TREE x the tree's largest |g| and DRYRUN_GRAD_OWN x its own
# (tests/test_torch_dryrun.py's limits against JAX); the relaxation by the
# optimize phase's checks (positions within OPT_POS_ATOL, energies within E_TOL); the
# train step's loss, its gradient norm and the fit's first validation loss
# within DP_METRIC_RTOL; its losses after the fit and the restore within
# DRYRUN_FIT_RTOL: 24 AdamW steps from sums in another order part the two
# runs' weights (2.7e-3 on the H100, where the first step's gradients agree
# to ~1e-7), while each run's restore reproduces its own loss to 1e-6;
# `fit_witnesses` measures the gap two one-process fits open when their
# batches differ only in row order, or their gradients by FIT_NOISE. The kernels are held against their plain
# versions at every shape the dry run gave them (`dryrun_kernel_checks`)
DRYRUN_LOSS_RTOL, DRYRUN_GRAD_TREE, DRYRUN_GRAD_OWN, DRYRUN_FIT_RTOL = 1e-5, 1e-5, 1e-4, 1e-2
DRYRUN_RANKS = 4
DRYRUN_TIMEOUT = 600  # s, the ranks of one phase


def recorded_steps(log: list):
    """A context in which every Trainer step appends its (global) train loss
    to `log`: the dry run's fits are compared step by step."""
    from unittest import mock

    from nabladft_tpu_torch.train import engine

    step = engine.Trainer._train_step

    def recorded(self, batch):
        metrics = step(self, batch)
        log.append(float(metrics["train/total"]))
        return metrics

    return mock.patch.object(engine.Trainer, "_train_step", recorded)


def dryrun_rank(r: int, world: int, backend: str, store: str, work: str, out: str) -> None:
    """One rank of a dry-run phase (started with `spawn`): the group (the
    port's collective timeout), `dryrun_multichip(world)` at full width on its
    card, its printed lines in `<out>.out`, its results pickled to `out`."""
    import contextlib
    import pickle

    from nabladft_tpu_torch import dryrun
    from nabladft_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = r if backend == "nccl" else 0
    dev = torch.device("cuda", card)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group(backend, init_method=f"file://{store}", rank=r,
                                         world_size=world, timeout=dist.TIMEOUT)
    losses = []
    try:
        with open(out + ".out", "w") as log, contextlib.redirect_stdout(log), \
                recorded_steps(losses):
            res = dryrun.dryrun_multichip(world, "full", dev, workdir=Path(work))
        torch.cuda.synchronize(dev)
        info = dict(rank=r, world=dist.world_size(), backend=torch.distributed.get_backend(),
                    card=card, step_losses=losses)
    finally:
        torch.distributed.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(dict(phases=res, **info), f)


def _dryrun_counts(name: str, phase: dict) -> dict:
    """A dry-run phase's launch counts on one rank: A-D as the dp phases'
    (6 a layer per train step and evaluation, C and D per step, B's gW
    stage never); I-L as qhnet_train's per step for the config's remat;
    PhiSNet none."""
    from nabladft_tpu_torch import dryrun

    full = dryrun.SIZES["full"]
    n_layers = full["painn"]["n_interactions"]
    if name == "train_step":
        return _painn_counts(n_layers, 1, 0)
    if name == "relax":  # "off": one evaluation a step and the first
        return _painn_counts(n_layers, 0, 1 + phase["nsteps"])
    if name == "fit":
        return _painn_counts(full["fit_painn"]["n_interactions"], phase["steps"],
                             11 * phase["val_batches"])
    want = dict.fromkeys(all_launches(), 0)
    if name == "hamiltonian":
        kw = full["qhnet"]
        layers, remat = kw["num_layers"], 2 if kw.get("remat", True) else 1
        pairs = layers - 1 - kw.get("start_layer", 2)
        want.update(qhnet_conv_fwd=remat * layers, qhnet_conv_bwd=layers,
                    qhnet_pair_fwd=remat * pairs, qhnet_pair_bwd=pairs)
    return want


def _grad_gaps(got: dict, want: dict) -> dict:
    """The largest gradient gap over the tree's largest |g| and over each
    tensor's own."""
    gmax = max(float(np.abs(g).max()) for g in want.values())
    tree = own = 0.0
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        tree, own = max(tree, err / gmax), max(own, err / max(float(np.abs(w).max()), 1e-30))
    return {"tree": tree, "own": own}


DRYRUN_PAINN_PHASES, DRYRUN_QHNET_PHASES = ("train_step", "relax", "fit"), ("hamiltonian",)


def dryrun_kernel_checks(dev, shapes: dict) -> dict:
    """Each kernel of the dry run against its plain version, within
    KERNEL_RTOL as the kernel phases hold it, at every (B, A) its phases
    gave it (`shapes`: {"painn": [...], "qhnet": [...]}): A, B with and
    without gW, C and D at PaiNN's widths (`kernel_inputs`), I-L at QHNet's
    (`qhnet_kernel_inputs`). Returns {"<kernel> <[B, A]>": max_rel_err}."""
    from nabladft_tpu_torch.ops import painn_fused as pf, qhnet_tp as qt

    def as_tuple(t):
        return t if isinstance(t, tuple) else (t,)

    out = {}

    def held(k, shape, fn, ref, args):
        err = compare(as_tuple(fn(*args)), as_tuple(ref(*args)))
        check(err["max_rel_err"] <= KERNEL_RTOL, f"dry run kernel {k} error at {shape}: {err}")
        out[f"{k} {shape}"] = err["max_rel_err"]

    for b, a in sorted(shapes["painn"]):
        x = kernel_inputs(dev, a, b)
        shape = [b, a, KR, KF]
        b_args = [x[k] for k in ("rbf", "rbfp", "phi", "v", "unit_t", "w", "gds", "gdv")]
        held("A", shape, pf.painn_fwd, pf.painn_message_reference,
             [x[k] for k in ("rbf", "phi", "v", "unit_t", "w")])
        held("B", shape, pf.painn_bwd, pf.painn_message_bwd_reference, b_args)
        held("B without gW", shape, lambda *t: pf.painn_bwd(*t, need_gw=False)[:4],
             lambda *t: pf.painn_message_bwd_reference(*t, need_gw=False)[:4], b_args)
        held("C", shape, pf.painn_dual_fwd, pf.painn_dual_fwd_reference, [x[k] for k in C_ARGS])
        held("D", shape, pf.painn_dual_bwd, pf.painn_dual_bwd_reference, [x[k] for k in D_ARGS])
        del x
    fns = {"I": (qt.qhnet_conv_fwd, qt.conv_fwd_reference),
           "J": (qt.qhnet_conv_bwd, qt.conv_bwd_reference),
           "K": (qt.qhnet_pair_fwd, qt.pair_fwd_reference),
           "L": (qt.qhnet_pair_bwd, qt.pair_bwd_reference)}
    for b, a in sorted(shapes["qhnet"]):
        x = qhnet_kernel_inputs(dev, b, a, QH_C, seed=SEED + 5000 + 100 * b + a)
        for k, (fn, ref) in fns.items():
            held(k, [b, a, QH_C], fn, ref, [x[n] for n in QH_ARGS[k]])
        del x
    torch.cuda.empty_cache()
    return out


class _RowsPermuted:
    """A train loader whose every batch has its rows (molecules) in a seeded
    other order: the same sums, added in another order."""

    def __init__(self, loader, seed: int):
        self.loader, self.rng = loader, np.random.default_rng(seed)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield _mols(batch, torch.from_numpy(self.rng.permutation(batch.z.shape[0])))


FIT_NOISE = 1e-7  # x the tree's largest |g|: the gradient witness's noise


def gradient_noise(scale: float, seed: int):
    """A context in which every Trainer step's summed gradients get seeded
    Gaussian noise of `scale` x the tree's largest |g| before the update."""
    from unittest import mock

    from nabladft_tpu_torch.train import engine

    step = engine.Trainer._step_grads
    gens = {}

    def noisy(self, batch):
        losses = step(self, batch)
        grads = [p.grad for p in self._params()]
        top = max(float(g.abs().max()) for g in grads)
        dev = grads[0].device
        gen = gens.setdefault(dev, torch.Generator(device=dev).manual_seed(seed))
        for g in grads:
            g.add_(torch.randn(g.shape, generator=gen, device=dev, dtype=g.dtype),
                   alpha=scale * top)
        return losses

    return mock.patch.object(engine.Trainer, "_step_grads", noisy)


def fit_witnesses(world: int, dev, work: Path, one: dict) -> dict:
    """The dry run's fit (phase 5) twice more in one process: every train
    batch's rows permuted ("rows_permuted": the same sums in another order),
    and every step's gradients perturbed by FIT_NOISE ("gradient_noise").
    Each gives the gap it opens to the one process's fit, beside
    DRYRUN_FIT_RTOL, with its train losses step by step."""
    import contextlib
    from unittest import mock

    from nabladft_tpu_torch import dryrun

    class Permuted(dryrun.DataModule):
        def train_dataloader(self):
            return _RowsPermuted(super().train_dataloader(), SEED + 11)

    out = {}
    for name, change in (("rows_permuted", mock.patch.object(dryrun, "DataModule", Permuted)),
                         ("gradient_noise", gradient_noise(FIT_NOISE, SEED + 12))):
        losses, sub = [], work / name
        sub.mkdir()
        with change, recorded_steps(losses), open(sub / "printed.out", "w") as log, \
                contextlib.redirect_stdout(log):
            res = dryrun.fit_phase(world, dryrun.SIZES["full"], dev, sub)
        check(res["steps"] == one["steps"] and res["loss0"] == one["loss0"],
              f"the {name} fit's steps and first loss: {res} vs {one}")
        out[name] = dict({k: abs(res[k] / one[k] - 1) for k in ("loss1", "loss2")},
                         step_losses=losses)
    return out


def dryrun_phase(tmp: Path, phase: str, backend: str, world: int) -> dict:
    """`world` ranks run the five dry-run phases in one start, against one
    process on the same batches and weights (see the module docstring);
    returns the ranks' summed launch counts."""
    import contextlib
    import multiprocessing
    import pickle

    from nabladft_tpu_torch import dryrun

    run_dir = tmp / phase
    work, one_dir = run_dir / "work", run_dir / "one"
    work.mkdir(parents=True)
    one_dir.mkdir()
    ctx = multiprocessing.get_context("spawn")
    outs = [run_dir / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=dryrun_rank, args=(r, world, backend, str(run_dir / "store"),
                                                   str(work), str(outs[r])))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:  # one process, meanwhile: every phase unsharded on the same global batches
        t1 = time.perf_counter()
        one_losses = []
        with open(one_dir / "printed.out", "w") as log, contextlib.redirect_stdout(log), \
                recorded_steps(one_losses):
            one = dryrun.dryrun_multichip(world, "full", torch.device("cuda"), workdir=one_dir)
        torch.cuda.synchronize()
        one_seconds = time.perf_counter() - t1
    finally:
        for p in procs:
            p.join(timeout=DRYRUN_TIMEOUT)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.exitcode == 0 and out.exists(), f"{phase} rank {r} exit code {p.exitcode}")
    ranks = []
    for out in outs:
        with open(out, "rb") as f:
            ranks.append(pickle.load(f))
    check([(x["rank"], x["world"], x["backend"]) for x in ranks]
          == [(r, world, backend) for r in range(world)], f"{phase} groups")
    printed = Path(str(outs[0]) + ".out").read_text().splitlines()
    oks = [line for line in printed if line.startswith("dryrun") and ": ok" in line]
    check(len(oks) == len(dryrun.PHASES) + 1 and oks[-1] == f"dryrun_multichip({world}): ok",
          f"{phase}: rank 0 printed {printed}")
    for x in ranks[1:]:
        check(not Path(str(outs[x["rank"]]) + ".out").read_text(), f"{phase}: rank 0 alone prints")

    gaps, launches_by_rank = {}, {}
    for x in ranks:
        r, ph = x["rank"], x["phases"]
        counts = {}
        for name, res in ph.items():
            want = _dryrun_counts(name, res)
            check(res["launches"] == want,
                  f"{phase} rank {r} {name} launches {res['launches']}, expected {want}")
            counts[name] = {k: n for k, n in res["launches"].items() if n}
        launches_by_rank[r] = counts
        g = gaps[r] = {}
        for k in ("loss", "grad_norm"):
            g["train_step_" + k] = abs(ph["train_step"][k] / one["train_step"][k] - 1)
            check(g["train_step_" + k] <= DP_METRIC_RTOL, f"{phase} rank {r} train step {g}")
        for name in ("hamiltonian", "phisnet"):
            got, want = ph[name], one[name]
            g[name + "_loss"] = abs(got["loss"] / want["loss"] - 1)
            g[name + "_grad"] = _grad_gaps(got["grads"], want["grads"])
            check(g[name + "_loss"] <= DRYRUN_LOSS_RTOL
                  and g[name + "_grad"]["tree"] <= DRYRUN_GRAD_TREE
                  and g[name + "_grad"]["own"] <= DRYRUN_GRAD_OWN,
                  f"{phase} rank {r} {name}: {g}")
        rx, ox = ph["relax"], one["relax"]
        sl = rx["rows"]
        check(rx["nsteps"] == ox["nsteps"]
              and np.array_equal(rx["converged"], ox["converged"][sl]),
              f"{phase} rank {r} relaxation steps / converged")
        g["relax_pos"] = float(np.abs(rx["pos"] - ox["pos"][sl]).max())
        g["relax_energy"] = float(np.abs(rx["energy"] - ox["energy"][sl]).max())
        check(g["relax_pos"] <= OPT_POS_ATOL, f"{phase} rank {r} positions {g['relax_pos']}")
        np.testing.assert_allclose(rx["energy"], ox["energy"][sl], **E_TOL)
        g["fit"] = {k: abs(ph["fit"][k] / one["fit"][k] - 1) for k in ("loss0", "loss1", "loss2")}
        check(ph["fit"]["steps"] == one["fit"]["steps"] and g["fit"]["loss0"] <= DP_METRIC_RTOL
              and max(g["fit"].values()) <= DRYRUN_FIT_RTOL,
              f"{phase} rank {r} fit {g['fit']}: {ph['fit']['steps']} steps")
    # every (B, A) the ranks' and the one process's phases gave the kernels,
    # each kernel held there against its plain version
    shapes = {fam: sorted({tuple(sh) for res in [one] + [x["phases"] for x in ranks]
                           for name in names for sh in res[name]["shapes"]})
              for fam, names in (("painn", DRYRUN_PAINN_PHASES), ("qhnet", DRYRUN_QHNET_PHASES))}
    check(all(shapes.values()), f"{phase}: kernel shapes {shapes}")
    kernel_errs = dryrun_kernel_checks(torch.device("cuda"), shapes)
    witness_dir = run_dir / "witness"
    witness_dir.mkdir()
    witness = fit_witnesses(world, torch.device("cuda"), witness_dir, one["fit"])
    # the fits' train losses step by step, each against the one process's:
    # the ranks' (the same on every rank) and the witnesses'
    n = one["fit"]["steps"]

    def step_gaps(losses):
        return [abs(a / b - 1) for a, b in zip(losses[-n:], one_losses[-n:])]

    check(all(x["step_losses"][-n:] == ranks[0]["step_losses"][-n:] for x in ranks),
          f"{phase}: the ranks' train losses")
    fit_step_gaps = {"ranks": step_gaps(ranks[0]["step_losses"]),
                     **{k: step_gaps(w.pop("step_losses")) for k, w in witness.items()}}
    emit(phase, backend=backend, ranks=world, cards=len({x["card"] for x in ranks}),
         grid=ranks[0]["phases"]["hamiltonian"]["grid"], printed=oks, gaps_to_one_process=gaps,
         fit_witnesses=witness, fit_step_loss_gaps=fit_step_gaps, kernel_shapes=shapes,
         kernel_max_rel_err=kernel_errs,
         launches_by_rank=launches_by_rank,
         losses={name: ranks[0]["phases"][name]["loss"]
                 for name in ("train_step", "hamiltonian", "phisnet")},
         relax={"nsteps": ranks[0]["phases"]["relax"]["nsteps"],
                "converged": int(sum(x["phases"]["relax"]["converged"].sum() for x in ranks))},
         fit={k: ranks[0]["phases"]["fit"][k] for k in ("loss0", "loss1", "loss2", "steps")},
         seconds=seconds, one_process_seconds=one_seconds,
         tolerances={"loss_rel": DRYRUN_LOSS_RTOL, "grad_tree": DRYRUN_GRAD_TREE,
                     "grad_own": DRYRUN_GRAD_OWN, "positions_abs": OPT_POS_ATOL,
                     "energy": E_TOL, "train_step_rel": DP_METRIC_RTOL,
                     "fit_rel": DRYRUN_FIT_RTOL, "kernel_rel": KERNEL_RTOL,
                     "witness_gradient_noise": FIT_NOISE})
    total = dict.fromkeys(all_launches(), 0)
    for x in ranks:
        for res in x["phases"].values():
            for k, n in res["launches"].items():
                total[k] += n
    return total


def dryrun_nccl_phase(tmp: Path) -> dict:
    """dryrun_nccl: over min(cards, DRYRUN_RANKS) cards when there are two or
    more (a 2×2 grid on four, 1×2 on two); otherwise a line saying it did
    not run."""
    n = torch.cuda.device_count()
    if n < 2:
        emit("dryrun_nccl", ran=False, device_count=n,
             reason=f"nccl needs a card a rank; this machine has {n}")
        return dict.fromkeys(all_launches(), 0)
    return dryrun_phase(tmp, "dryrun_nccl", "nccl", min(n, DRYRUN_RANKS))


ALL_KERNELS = {"A": "painn_fwd", "B": "painn_bwd", "C": "painn_dual_fwd", "D": "painn_dual_bwd",
               "E": "schnet_fwd", "F": "schnet_bwd", "G": "schnet_dual_fwd",
               "H": "schnet_dual_bwd", "I": "qhnet_conv_fwd", "J": "qhnet_conv_bwd",
               "K": "qhnet_pair_fwd", "L": "qhnet_pair_bwd", "M": "escn_fwd",
               "N": "escn_bwd", "O": "eqv2_fwd", "P": "eqv2_bwd"}  # kernel -> its launch counter


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in fp32, as the JAX package's (cuBLAS may reduce
    # them in bf16 where this is allowed; the bf16 predict phases record the gap)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from concurrent.futures import ThreadPoolExecutor

    from nabladft_tpu_torch.data.synthetic import write_random_db
    from nabladft_tpu_torch.ops import _kernels

    seconds = {}
    t_all = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    nvcc_version = subprocess.run([_kernels.nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    sources = ("painn_fused", "schnet_fused", "qhnet_tp", "escn_layer", "eqv2_attn")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        builds = dict(zip(sources, pool.map(_kernels.build, sources)))
    seconds["build"] = time.perf_counter() - t0
    ptxas = {k: ptxas_summary(v["log"]) for k, v in builds.items()}
    emit("env", device=card, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_version,
         build_seconds=seconds["build"],
         build_seconds_by_source={k: v["seconds"] for k, v in builds.items()},
         ptxas=ptxas)

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    dev = torch.device("cuda")
    rows = timed("kernels_painn", kernel_phases, dev, card, ptxas)
    rows.update(timed("kernels_painn_bf16", kernel_bf16_phases, "painn", dev, card, ptxas))
    rows.update(timed("kernels_schnet", schnet_kernel_phases, dev, card, ptxas))
    rows.update(timed("kernels_schnet_bf16", kernel_bf16_phases, "schnet", dev, card, ptxas))
    rows.update(timed("kernels_qhnet", qhnet_kernel_phases, dev, card, ptxas))
    rows.update(timed("kernels_escn", escn_kernel_phases, dev, card, ptxas))
    rows.update(timed("kernels_eqv2", eqv2_kernel_phases, dev, card, ptxas))
    rows.update(timed("kernels_so2_bf16", so2_bf16_kernel_phases, dev, card, ptxas))
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        db = timed("db_write", write_random_db, tmp / "smoke.db", N_MOLS, MIN_ATOMS, MAX_ATOMS,
                   SEED)
        for family in FAMILIES:
            for job, phase in (("predict", predict_phase), ("train", train_phase)):
                path = f"{family}_{job}"
                by_path[path] = timed(path, phase, tmp, db, family)
            if family == "painn":  # from the train phase's best checkpoint
                by_path["painn_optimize"] = timed("painn_optimize", optimize_phase, tmp, db)
                by_path["painn_bf16_optimize"] = timed("painn_bf16_optimize",
                                                       optimize_bf16_phase, tmp, db)
                by_path["painn_profiled_train"] = timed("painn_profiled_train",
                                                        profiled_train_phase, tmp, db)
                by_path["painn_pbc"] = timed("painn_pbc", pbc_phase, tmp)
                # data parallelism, after painn_train, whose run nccl1 repeats
                by_path["painn_dp_nccl1"] = timed("painn_dp_nccl1", dp_nccl1_phase, tmp, db)
                by_path["painn_dp_gloo2"] = timed("painn_dp_gloo2", dp_phase, tmp, db,
                                                  "painn_dp_gloo2", "gloo", 2)
                by_path["painn_dp_nccl"] = timed("painn_dp_nccl", dp_nccl_phase, tmp, db)
                # the multi-card dry run: its five phases in one start of the ranks
                by_path["dryrun_gloo4"] = timed("dryrun_gloo4", dryrun_phase, tmp,
                                                "dryrun_gloo4", "gloo", DRYRUN_RANKS)
                by_path["dryrun_nccl"] = timed("dryrun_nccl", dryrun_nccl_phase, tmp)
            # after the fp32 phases, whose readings they print
            for job, phase in (("train", bf16_train_phase), ("predict", bf16_predict_phase)):
                path = f"{family}_bf16_{job}"
                by_path[path] = timed(path, phase, tmp, db, family)
            by_path[f"{family}_bf16_headline"] = timed(f"{family}_bf16_headline",
                                                       bf16_headline_phase, family)
        by_path["qhnet_train"] = timed("qhnet_train", qhnet_train_phase, tmp)
        by_path["phisnet_train"] = timed("phisnet_train", phisnet_train_phase, tmp)
        for family in DIRECT:
            for job, phase in (("predict", direct_predict_phase), ("train", direct_train_phase)):
                path = f"{family}_{job}"
                by_path[path] = timed(path, phase, tmp, db, family)
        for family in DIRECT:  # after both families' fp32 phases, whose readings they print
            by_path[f"{family}_bf16"] = timed(f"{family}_bf16", direct_bf16_phase, tmp, db,
                                              family)
        for family in ENERGY:  # predict from the train phase's best checkpoint
            for job, phase in (("train", energy_train_phase), ("predict", energy_predict_phase)):
                path = f"{family}_{job}"
                by_path[path] = timed(path, phase, tmp, db, family)
        for family in ("dimenetpp", "graphormer3d", "gemnet_oc"):
            by_path[f"{family}_bf16"] = timed(f"{family}_bf16", energy_bf16_phase, tmp, db, family)
        by_path["dimenetpp_dense"] = timed("dimenetpp_dense", dimenetpp_dense_phase, tmp, db)
        by_path["eqv2_ref_bf16"] = timed("eqv2_ref_bf16", eqv2_ref_bf16_phase, tmp, db)
        restore_db = timed("restore_db_write", write_random_db, tmp / "restore.db", BATCH,
                           MIN_ATOMS, RESTORE_MAX_ATOMS, RESTORE_SEED)
        for path, phase in (("pretrained_painn", pretrained_painn_phase),
                            ("pretrained_escn", pretrained_escn_phase),
                            ("pretrained_eqv2", pretrained_eqv2_phase),
                            ("flax_restore", flax_restore_phase),
                            ("amsgrad_resume", amsgrad_resume_phase)):
            by_path[path] = timed(path, phase, tmp, restore_db)
        # over qhnet_train's Hamiltonian DB
        by_path["pretrained_qhnet"] = timed("pretrained_qhnet", pretrained_qhnet_phase, tmp)
    counters = dict(ALL_KERNELS, **{f"{k}_bf16": c for spec in BF16_FAMILIES.values()
                                    for k, (_, _, c) in spec["kernels"].items()},
                    **{f"{k}_bf16": v[3] for k, v in SO2_BF16_KERNELS.items()})
    for k, counter in counters.items():
        rows[k]["launches_by_path"] = {p: n[counter] for p, n in by_path.items()}
        rows[k]["launches"] = sum(rows[k]["launches_by_path"].values())
        check(rows[k]["launches"] > 0, f"kernel {k} launched on its path")
    seconds["total"] = time.perf_counter() - t_all
    emit("timing", seconds=seconds)
    print(json.dumps({"kernels": [rows[k] for k in counters]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
