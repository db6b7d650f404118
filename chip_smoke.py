#!/usr/bin/env python3
"""Drive geot_tpu_torch's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp-step-ms <checkout> [<checkout> ...]

The second form times phase 14's two-rank flagship step (8 steps, gloo,
both ranks on one card) in each checkout given, in that order: one JSON
line of step milliseconds a run (``dp_step_ms``).

Phases, each printed with the seconds elapsed when it starts:
1. device: the card's name and power limit; TF32 off.
2. build: the CUDA kernels, one nvcc per source from
   ``geot_tpu_torch/csrc``, all started together.
3. kernels: each kernel against its plain PyTorch version at the shapes the
   paths give it, plus cases with duplicated points (ties): FPS indices and
   kNN indices equal, kNN squared distances bit-equal. FPS: the card's
   cluster size per batch, the cluster exchange alone (8,191 steps of
   block barrier, write-to-peers, synchronisation and reduction, no
   distance work) at each cluster size, then the cluster kernel
   (``fps_cluster``) at (1|2|6, 16000) -> 8192, ties, an odd N and an N
   that its shape rule sends past the cluster (to ``fps_bucket``), and
   the cluster and one-block (``fps``) kernels' times in turns. kNN: the
   split kernel (``knn_split``) and the one-thread-per-query kernel
   (``knn_small_k``) against the plain version, each other and the path's
   route (``knn_route``) at the serving path's 8 searches and ties, each
   timed as wrapper calls and kernel-only (a CUDA graph of the calls).
   The bucket-pruned kernels: ``fps_bucket`` bit-equal to its plain
   version and the path's FPS at (1|6, 16000) -> 8192, ties and a whole
   150,000-point scan -> 8192 (against ``fps_block``, the route it took
   over), kernel-only and with its plan, beside the path's kernel;
   ``knn_small_k_pruned`` bit-equal to its plain version, ``knn_split``
   and the route at the scan's 8 searches, ties, the upsample of a
   150,000-point scan, (1, 155648) x (1, 16000), and ``knn_route``'s
   crossover shapes (the top2 self-search, (2, 16000) x (2, 16000), and
   (24576|32768, 16000)), kernel-only and with its plan beside
   ``knn_split``, which it must beat where the route takes it (with its
   plan on the device, and as wrapper calls, the median of 7 runs); its
   plan's Morton and prepare kernels against their plain versions. Each with
   its skip share and two bounds: brute force, and the work done (the
   buckets updated, the tile-chunk pairs visited). Times from CUDA events
   after a warm-up.
4. serving: the flagship ``WholePartSeg`` at full width with seeded random
   weights serves 3 synthetic scans of 40,000 points through
   ``predict_scan``; the launch counters must show 1 ``fps_cluster``, 7
   ``knn_split`` and the upsample's pruned route (``morton``,
   ``knn_pruned_prepare``, ``knn_small_k_pruned``, one each) per scan and
   no other. Logits finite, labels FDI codes of the jaw, and the card's
   forward agrees with the same model's CPU forward.
5. http: 3 ``POST /predict`` requests with ``.npy`` bodies through
   ``engine.serve`` on 127.0.0.1.
6. train: the flagship FixMatch + NTM recipe at full width (batch 2 + 2 + 2
   of 16,000 points) from seeded weights on the synthetic loaders: the
   ``cal_mean_feature`` bootstrap over 2 labelled batches (1 ``fps_cluster``
   + 7 ``knn_split`` launches each), then 3 ``semi_step`` calls with the
   teacher (2 ``fps_cluster`` + 14 ``knn_split`` each). Losses finite,
   ``ema_t`` rows sum to 1, weights move. Then one step from the same
   state and batch (1 + 1 + 1 clouds, the trunk ``CMP_TRUNK``: 3 blocks
   at full width, dropout off) on the card and on the CPU, in float32 and
   in float64 (the CPU's searches computed once, ``cpu_search_memo``):
   loss terms within 1e-4 relative; per-tensor gradients within 1e-3 of
   the tensor's largest in float64 (5e-2 in float32, where batch-statistics
   BatchNorm amplifies rounding).
8. trainer: ``engine.train.parse_and_run`` in this process on
   ``cfgs/tooth_semi/transformer_finetune_fixmatch_ntm.yaml`` at full width,
   in a temporary root directory that is deleted afterwards. Run A: 2
   epochs of 12 steps on the synthetic 24-scan labelled and 48-scan
   unlabelled splits (cm bootstrap over 12 batches, validation after each
   epoch, the test split at epoch 2 on the best checkpoint, checkpoints
   every epoch): losses finite, val/test metrics in [0, 1], the reference's
   epoch scalars present, the latest/best/E1/E2 checkpoints written, and
   the launch counters equal to 2 ``fps_cluster`` + 14 ``knn_split`` a
   step, 1 + 7 a cm batch, 1 + 7 and two upsamples (the pruned route) a
   val/test batch of 2 scans, 0 for the other kernels. Run C: ``mode=val`` on A's best checkpoint gives A's best
   val metrics. Run B: ``mode=resume`` from A's epoch-1 checkpoint; its
   epoch-2 scalars agree with A's (each loss term within the spread
   measured between uninterrupted runs, ``RESUME_LOSS_RTOL``; metrics
   within 5e-3 absolute: atomics in the backward pass make the card's
   steps non-deterministic, and B prints how far). Then, in a child
   process with deterministic algorithms (``--resume-check``), the same 2
   epochs and the same resume: every epoch-2 scalar bit-equal.
   Prints epoch wall and host data time (with the YAML's
   ``dataloader.num_workers`` loader threads), host
   ms between steps, validate ms per scan (first pass apart), checkpoint
   bytes and save/load ms, and peak memory.
9. fast serving: the serving topology (``fast_pyramid=1024``,
   ``fast_graph``) through the entry points. ``fps_stratified`` on the
   card is bit-equal to the CPU's on a sampled scan and on a 2,000-point
   scan sampled to 16,000 (duplicates), and is a permutation; the
   flagship at full width with seeded weights serves 6 scans in float32
   and 6 in bfloat16 through ``predict_scan`` (latency, peak memory, a
   profiled window's device idle share), each scan launching 1
   ``fps_cluster``, 5 ``knn_split`` and the upsample's pruned route and
   nothing else; float32 on the
   card against the port's CPU forward (max |dlogit| <= 1e-3 x the logit
   p99, argmax agreement >= 0.999); bfloat16 on the card against the
   port's CPU bfloat16 forward (argmax agreement >= 0.98, max |dlogit| <=
   2 x the CPU's own bfloat16-vs-float32 difference; bounds fixed before
   the first card run); 2 test-time votes, a two-member ensemble, and
   ``predict_stream`` over 4 scans whose labels equal ``predict_scan``'s in
   the same draw order, each with its launch counts checked; one request
   to ``python -m geot_tpu_torch.engine.serve --fast`` in a child process,
   whose labels equal ``predict_scan``'s.
10. fast trainer: ``parse_and_run`` on
   ``cfgs/tooth_semi/transformer_finetune_fixmatch_ntm_fast.yaml`` (a
   student in the serving topology, the exact teacher) for 1 epoch with
   validation and the test pass, then ``mode=test`` with 2 votes on its
   best checkpoint: metrics in [0, 1], losses finite, launches checked
   against the counts the code implies, ``fps_cluster`` launches counted
   by shape ((6, 16000) -> 1024 and (2, 16000) -> 8192 once a step);
   prints epoch wall and data time, host ms between steps, peak memory.
11. semi-step branches: ``knn_split`` at the self-search of a whole cloud,
   (2, 16000) x (2, 16000), k = 2 (``Poly1FocalLoss_U_top2``), bit-equal to
   the plain version on sampled scans and on 2,000 distinct points sampled
   to 16,000, with its split plan and times; at full width (2 + 2 + 2
   clouds) one warm-up and 2 timed steps each of the flagship, all flags
   (feature-space, identity and contrast losses, ``pseudo_refine``,
   ``filter_outlier``), ``threed_anchors=4096`` and every other
   ``criterion_u`` name, losses finite and launches counted (top2: one
   more ``knn_split``, the self-search); the all-flags step's peak memory
   and, with the anchored and flagship steps, device time by kernel; the
   all-flags step on the card against the CPU (1 + 1 + 1 clouds,
   ``CMP_TRUNK``, the same contrast draws, ``cpu_search_memo``), in
   float32 and float64: loss terms
   within 1e-4 relative, the feature-space term within 1e-3 of the whole
   loss and the rest of the loss within 1e-4, ``ema_t`` within 1e-5, the
   bank's ``ptr`` equal; ``skip_nonfinite_updates`` with a NaN in a strong
   view: skipped, the whole state bit-equal, the next step trains; the
   trainer on the flagship YAML with every switch, ``threed_anchors=4096``
   and ``ema_eval=0.99`` for 2 epochs: ``val`` and ``val_raw`` each epoch,
   the test pass on the tree that won, launches as the code implies.
12. supervised zoo: kernels 1 and 2 at the zoo's shapes on 4 sampled
   scans, bit-equal to their plain versions and timed kernel-only (a CUDA
   graph): the FPS chain of PointNet++ and PointMLP (16000 -> 4000 ->
   1000 -> 250 -> 62), the transformer's 16000 -> 8192, the decoders'
   four k = 3 searches (supports of 62 to 4,000 points), a 62-point cloud
   on a 16-block cluster, 40 distinct points sampled to 1000 (index 0
   repeats) and duplicated supports. Then for each of
   ``cfgs/tooth_sup/{pointnet2,dgcnn,pointmlp,transformer}.yaml`` at its
   published width and batch: 1 warm and 2 timed supervised steps with
   their launches checked against the counts the code implies and peak
   memory, one profiled step (device time by kernel, idle share), one
   step on one cloud in float64 on the card and on the CPU (dropout off;
   loss and per-tensor gradient bounds ``_ZOO_CMP_TOL``), and
   ``parse_and_run`` for 1 epoch with validation, the test pass and
   checkpoints, then ``mode=test`` on its best checkpoint (same test
   metrics, launches checked).
13. file input and the serving CLI: kernels 1 and 2 at this phase's new
   shapes, bit-equal to their plain versions and timed kernel-only (the
   FPS chain and the decoders' four searches of a served zoo scan, B = 1;
   the full-resolution upsample of a 150,000-point scan, (1, 155,648) x
   (1, 16,000), k = 3). A Teeth3DS tree in a temporary directory (6 OBJ
   scans of 40,000 points and one of 150,000, JSON labels in FDI codes,
   ``data.json`` and the split lists): the OBJ parse time of the large
   scan; the test items equal the arrays written; ``parse_and_run`` on
   the flagship YAML with both ``data_root`` on the tree for 1 epoch with
   validation and the test pass (finite losses, launches as the code
   implies). The predict CLI on the card: the tree's OBJ scans as a
   directory (per-scan JSON, FDI codes of the jaw, ``n_points`` the
   vertex count, scans/s), one scan with ``--votes 2`` and one with
   ``--fast --ply`` (the PLY read back within its 5 decimals). A
   reference ``.pth`` (``{"model": {"module." + k: v}, "epoch": 3}``)
   predicts labels and logits bit-equal to the same weights as a
   state_dict file. Each ``cfgs/tooth_sup`` model at its published width
   serves a 40,000-point scan (median ms of 5 after a warm scan, launches
   a scan) and agrees with the same model on the CPU (phase 4's float32
   bound; DGCNN ``_SERVE_ZOO_*``). ``serve`` of PointNet++ answers an OBJ
   text body as ``predict_scan`` does, a failing prediction with 400, and
   ``/metrics`` counts both.
14. native parse, export, and data parallel: the 150,000-vertex OBJ
   through the C++ parser (``csrc/obj_loader.cpp``, built with ``g++``)
   bit-equal to the numpy parser, both timed; kernels 1 and 2 called
   through the custom ops ``geot::fps`` and ``geot::knn_small_k``
   bit-equal to their plain versions, the op's time beside the direct
   wrapper's. ``engine.export``'s CLI exports the flagship (seeded
   weights, B = 1, 16,000 points) exact and fast; a fresh process that
   imports torch and ``geot_tpu_torch.ops`` only loads both (no model
   module imported), and their logits are held to the eager forward's
   (``ARTIFACT_LOGIT_TOL`` of the logit scale, argmax equal) with the
   eager forward's launches. A 40,000-point scan through each artifact and
   eagerly, in turns (ms, launches a scan), and a profile of the fast
   scan both ways (the card's idle share, the host's operator calls).
   ``serve --artifact`` answers an OBJ body with ``predict_scan``'s eager
   labels. ``predict_stream`` over every card (``cuda:0`` twice on a
   one-card machine) gives one device's labels in input order. Two ranks
   train the flagship at full width through ``engine.launch`` (NCCL with a
   card each, else gloo with both on ``cuda:0``) on a Teeth3DS tree: 2
   epochs of one step of 2 + 2 + 2, dropout off, the trainer checking
   after each step that the ranks hold the same state and logging each
   rank's launches; against one process on the same batches: each rank's
   launches a step equal to the process's, the first step's loss terms
   within ``DP_FIRST_LOSS_RTOL``, AdamW's first moments after step 1
   tensor by tensor within ``DP_MOMENT_TOL``, the second step's loss
   terms within ``DP_SECOND_LOSS_RTOL``, the weights after step 2 within
   ``DP_WEIGHT_RMS_LR`` learning rates (root mean square); step ms of
   both. A control run whose ranks take rank 0's part of the gradient
   (times the world) in place of the sum must land past the last three
   bounds.
15. pretraining: ``cfgs/tooth_pretrain/viewgen.yaml`` at its width
   (trans_dim 384, depth 12, 512 groups of 32, 16,000 points, batch 2, 2
   views, ``ViewTransformer`` depth 2, 128 x 128 renders, cosine with 5
   warmup epochs) on the synthetic scans and renders: kernel 1 at the
   tokenizer's (2, 16000) -> 512 bit-equal to its plain version and timed
   kernel-only; 5 steps and 4 validation batches timed (median after the
   first, peak memory), one ``fps_cluster`` launch each and no other
   kernel; 2 profiled steps (device time by kernel, idle share); one forward with the same weights on the card and the CPU (loss
   within ``PRETRAIN_LOSS_RTOL`` relative, recon within
   ``PRETRAIN_RECON_ATOL``); ``parse_and_run`` for 2 epochs (the cuts
   ``PRETRAIN_CUTS`` logged) with each epoch's lr the schedule's, finite
   losses, ``latest``/``best``/``E1``/``E2``, then ``mode=resume`` from
   ``E1``, which writes epoch 2 only; one epoch from a manifest tree of OBJ
   clouds and 8-bit RGB PNG renders written with ``zlib`` (read back
   bit-equal); the flagship recipe with ``pretrain_encoder_path=<best>``
   on a Teeth3DS tree for one semi step of 2 + 2 + 2: the student's and the
   teacher's trunk equal to the checkpoint's encoder, nothing skipped,
   finite losses, phase 6's launches for the step.
16. the trainer's other switches at full width. (a) Every optimizer name
   of the factory, ``lookahead_adamw`` and ``layer_decay=0.75``: 3 updates
   from phase 6's gradients on the card and on the CPU, the weights within
   ``SW_OPT_TOL`` of each tensor's largest entry, then one full-width semi
   step each (losses finite, weights moved, phase 6's launches). (b)
   AdaHessian: 3 flagship steps at 2 + 2 + 2 x 16,000 points (ms beside
   phase 6's AdamW step, peak memory, 2 ``fps_cluster`` + 14 ``knn_split``
   a step), and its Hessian diagonal on the card against the CPU's (a
   child process, ``--hessian-cpu``) at 1 + 1 + 1 clouds and
   ``CMP_TRUNK`` in float64 from the same z, within ``SW_HESS_TOL``. (c)
   ``parse_and_run`` on the flagship YAML with ``SW_TRAINER`` (lookahead AdamW, layer decay, an
   update every 2 steps, a profiled epoch, uncached validation, wandb)
   on a Teeth3DS tree of 6 scans, 2 epochs of 3 steps: launches as the
   code implies, the trace names ``fps_cluster`` and ``knn_split``; then
   the deterministic child resumes from E1, one gradient into a group:
   every epoch-2 scalar bit-equal. (d) ``viewgen.yaml`` at its width on a
   manifest tree of 4 train clouds (2 steps), two ranks through
   ``engine.launch`` against one process (phase 14's bounds on the first
   step's loss and the weights after step 2, one ``fps_cluster`` a step
   a rank) and a control whose ranks reduce nothing, past both bounds.
   (e) ``TeethSegFinetuneDataset`` through ``cfgs/tooth_sup/
   transformer.yaml`` for 1 epoch on the tree.
17. the heritage tasks (``task: cls | partseg``). (a) Kernels 1 and 2 at
   their shapes, bit-equal to their plain versions and timed kernel-only:
   the FPS chains (32, 1024) -> 256 -> 64 -> 16 -> 4 (PointNet++
   classification), (32, 1024) -> 512 -> 256 -> 128 -> 64 (PointMLP) and
   (8, 2048) -> 512 -> 128 -> 32 -> 8 (part segmentation), clouds of 10 and
   17 points on a 16-block cluster (blocks that own no point), 40 distinct
   points sampled to 1024; the part decoders' k = 3 searches, (8, 32) x (8,
   8) to (8, 2048) x (8, 512), and a support with duplicates. (b) Each of
   ``cfgs/scanobjectnn/{pointnet2cls,dgcnncls,pointmlpcls}.yaml`` and
   ``cfgs/shapenetpart/{pointnet2part,pointmlppart}.yaml`` at its published
   width and batch on the synthetic sets: 1 warm and 2 timed supervised
   steps with their launches checked and peak memory; one float64 step on
   2 clouds on the card and on the CPU (``_ZOO_CMP_TOL`` of the encoder's
   family); ``parse_and_run`` for 1 epoch with validation and checkpoints,
   then ``mode=test`` on its best checkpoint (the same metrics, launches
   checked); ``pointnet2part`` once more with ``eval_refine`` and
   ``eval_category_mask``. (c) A ``ShapeNetPartNormal`` txt tree in a
   temporary directory: ``presample`` on the card (rows at ``fps_ref``'s
   indices), then ``pointnet2part.yaml`` on it for 1 epoch. Prints its
   seconds.
19. the reference layer and op API (``ops.compat``, the layer surface,
   VoteNet's SA modules). The main path with the launch counts at 0: (a)
   ``pointops`` / ``openpoints_pointops`` / ``pointnet2_utils`` at the
   flagship scan's shapes, (2, 16000): ``knn`` at k = 3 and 16, ``fps``
   and ``furthest_point_sample`` -> 512, ``fps_weight`` -> 512,
   ``queryandgroup`` and ``querygroup`` at nsample 32, ``interpolation``
   at k = 3 and 6, ``three_nn``, ``subtraction`` and ``aggregation`` at
   nsample 16 and C = 64; (b) VoteNet's four SA levels
   (``VOTENET_SA``) over ``PointnetSAModuleVotes`` at batch 8 x 20,000
   points, a warm and 2 timed forward + backward with peak memory; (c)
   DeepGCN's 2 ``ResDynBlock``s (64 channels, k 16, 8 x 4,096 points)
   the same way. Launches, counted part by part: the compat calls 2
   ``fps_cluster`` and 3 ``knn_split``, VoteNet 12 ``fps_cluster``,
   DeepGCN none; no other kernel.
   Then the compat searches and FPS and VoteNet's FPS chain bit-equal to
   their plain versions, timed kernel-only beside their bounds; float64
   card against CPU on 2 clouds (``REF64_RTOL``): VoteNet's SA levels,
   ``ASSA``, ``KMeansEmbed`` (256 groups, width 256) and
   ``TransformerEncoder`` (384 wide, depth 12, 6 heads, 256 tokens), and
   DeepGCN's rows (``DEEPGCN_ROWS_AGREE``: its feature search is float32
   on both); (d) the native ``grid_subsample`` of a 150,000-point scan
   against numpy, both timed. Prints its seconds.
20. the data side. The main paths with the launch counts at 0: (a)
   ``sample_pc`` on the card over trees of OFF meshes (deformed
   icospheres, one-line headers among them) at 1,024 and 2,048 points: one
   ``fps_cluster`` launch a mesh and no other kernel, each mesh's FPS of
   its dense samples, (1, 4096) -> 1024 and (1, 8192) -> 2048, bit-equal to
   ``fps_ref`` on the card, the PLY files read back through ``IO.get``
   equal to those samples, kernel 1 timed kernel-only at both shapes; (b)
   ``viewgen.yaml``'s model at full width over synthetic ``ShapeNet`` at
   1,024 points with 128 x 128 renders: kernel 1 at (2, 1024) -> 512
   bit-equal and timed, 5 steps (a launch each, step ms, peak memory), the
   first step card against CPU: in float32 the loss
   (``SHAPENET_STEP_RTOL``) and the encoder's features
   (``SHAPENET_FEAT32_TOL``), in float64 the loss, the features and every
   gradient (``SHAPENET_STEP64_TOL``, ``SHAPENET_GRAD64_TOL``);
   ``parse_and_run`` for one epoch and its validation (a launch a step
   and a val batch);
   (c) ``pointnet2part.yaml`` with ``HERITAGE_MIX`` (Cutmix and the new
   transforms) on its train split: the loader's batches equal with 1 and
   4 threads, every batch mixed, 3 steps with phase 17's launches; (d)
   ``class_contrast_loss`` with 1 and 6 subclasses and with teacher
   features, ``pcc_top2_loss`` and ``pseudo_label_from_prototype`` at
   (2, 16000, 64) and 17 classes, forward and backward, float32 ms and
   peak memory, float64 card against CPU on the same draws within
   ``CC64_TOL``; no kernel launches. Prints its seconds.
Phase 3 also holds ``fps_cluster`` at the serving topology's prefix,
(1|6, 16000) -> 1024 and a duplicate-heavy cloud, and ``knn_split`` at a
fast scan's 6 searches, against their plain versions, with times and
bounds.
Then the ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; without a CUDA device it exits 1 at once.

    python3 chip_smoke.py --profile

adds, after phase 13, a ``torch.profiler`` trace of 3 served scans, 2
train steps and 2 ``_fast.yaml`` train steps: device time by kernel and
the device's busy share of the wall time.

    python3 chip_smoke.py --resume-spread PAIRS

measures what phase 8's run B is held to: PAIRS pairs of uninterrupted
2-epoch runs of phase 8's config with the card's default backward, and a
resume of each pair's first run from its epoch-1 checkpoint; prints the
relative spread of each loss term between them (``RESUME_SPREAD`` line).

"""
from __future__ import annotations

import faulthandler
import io
import json
import math
import statistics
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

T0 = time.perf_counter()
# the script's own watchdog, under the 1,200 s a run may take: with the
# host-bound phases the whole script ran 1,032 s on one machine and past
# 1,100 s on another the same day
WATCHDOG_S = 1170
FP32_PEAK = 67e12        # H100 SXM fp32 outside the tensor cores, at 700 W
HBM_PEAK = 3.35e12       # bytes/s
FULL_POWER_W = 700.0


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_median(fn, reps: int, runs: int = 7) -> float:
    """Median over ``runs`` of ``cuda_ms(fn, reps)``: a call that the host
    bounds meets a stall of the shared host now and then, and one mean of
    ``reps`` calls carries the whole stall."""
    return statistics.median(cuda_ms(fn, reps) for _ in range(runs))


class Bound:
    """Least time for a piece of work: the larger of its bytes over the
    memory rate and its fp32 operations over the fp32 peak, both scaled by
    the card's power limit over 700 W."""

    def __init__(self, power_limit_w: float):
        self.scale = min(1.0, power_limit_w / FULL_POWER_W)

    def __call__(self, flops: float, nbytes: float):
        t_ops = flops / (FP32_PEAK * self.scale)
        t_bytes = nbytes / (HBM_PEAK * self.scale)
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


# the flagship of the card-against-CPU steps (phases 6, 11, 16 (b) and
# 18's semi step): stochastic depth and dropout off, the width (384)
# kept, 3 of the 12 blocks. At full depth their CPU sides took 95, 134
# and 166 s of a 1,032 s run on a slow host, and a slower one reached the
# 1,100 s watchdog in phase 18; the timed steps stay at full depth
CMP_TRUNK = {"drop_path_rate": 0.0, "head_dropout": 0.0, "depth": 3,
             "extract_layers": [1, 2, 3]}

# the CPU sides' plain searches, by their inputs' bytes (cpu_search_memo)
_SEARCH_MEMO: dict = {}
_SEARCH_STATS = {"hits": 0, "misses": 0}


class cpu_search_memo:
    """Inside ``with cpu_search_memo():`` the plain FPS and kNN of CPU
    tensors (``ops.fps.fps_ref``, ``ops.knn._knn_tiled``) give a copy of
    their earlier result for equal float32 inputs, computed once per
    process. The card-against-CPU steps of phases 6, 11 and 16 (b) search
    the same clouds in float32 and in float64 (the searches cast to
    float32), and most of a CPU step is those loops. A result depends on
    nothing but its inputs, so a hit is what a new call would return; an
    input that needs a gradient, or a CUDA tensor, is searched as usual.
    ``load`` merges a file that ``save`` wrote (for a child process)."""

    def __init__(self, load=None):
        self.load = load

    @staticmethod
    def _key(*parts):
        import hashlib

        import torch

        h = hashlib.blake2b(digest_size=16)
        for p in parts:
            if isinstance(p, torch.Tensor):
                t = p.detach().contiguous()
                h.update(repr((tuple(t.shape), t.dtype)).encode())
                h.update(t.numpy().tobytes())
            else:
                h.update(repr(p).encode())
        return h.hexdigest()

    @staticmethod
    def _cached(compute, *parts):
        """``compute()``, or a copy of its result for equal ``parts``."""
        import torch

        if any(isinstance(t, torch.Tensor) and (t.device.type != "cpu"
                                                or t.requires_grad)
               for t in parts):
            return compute()
        key = cpu_search_memo._key(*parts)
        if key in _SEARCH_MEMO:
            _SEARCH_STATS["hits"] += 1
        else:
            _SEARCH_STATS["misses"] += 1
            _SEARCH_MEMO[key] = compute()
        out = _SEARCH_MEMO[key]
        return (tuple(o.clone() for o in out) if isinstance(out, tuple)
                else out.clone())

    def __enter__(self):
        import importlib

        import torch

        fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
        knn_mod = importlib.import_module("geot_tpu_torch.ops.knn")

        if self.load and os.path.exists(self.load):
            _SEARCH_MEMO.update(torch.load(self.load))
        self.mods = (fps_mod, knn_mod)
        self.real = (fps_mod.fps_ref, knn_mod._knn_tiled)
        real_fps, real_knn = self.real

        def fps_ref(xyz, npoint, weights=None):
            # fps_ref searches xyz.float(): key on that
            return self._cached(lambda: real_fps(xyz, npoint, weights),
                                "fps", xyz.float(), weights, npoint)

        def knn_tiled(query, support, k, tile=knn_mod._TILE):
            return self._cached(lambda: real_knn(query, support, k, tile),
                                "knn", query, support, k, tile)

        fps_mod.fps_ref, knn_mod._knn_tiled = fps_ref, knn_tiled
        return self

    def __exit__(self, *exc):
        fps_mod, knn_mod = self.mods
        fps_mod.fps_ref, knn_mod._knn_tiled = self.real
        return False

    @staticmethod
    def save(path):
        import torch

        torch.save(dict(_SEARCH_MEMO), path)

# launches of one full-resolution upsample of a scan of 40,000 points or
# more, (1, 40960 or more) x (1, 16000): knn_small_k's pruned route
# (ops.knn_route), the plan's Morton and prepare kernels and the search
UPSAMPLE = {"morton": 1, "knn_pruned_prepare": 1, "knn_small_k_pruned": 1}


def _with_upsamples(counts: dict, n: int) -> dict:
    """``counts`` and n upsamples' launches."""
    out = dict(counts)
    for k, v in UPSAMPLE.items():
        out[k] = out.get(k, 0) + n * v
    return out


def phase_device():
    import torch

    log("phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    limit_w = float(smi.rsplit(",", 1)[1].strip().split()[0])
    log(f"device {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    return name, smi, limit_w


def phase_build():
    from geot_tpu_torch.ops import _build

    log("phase 2: build")
    t = time.perf_counter()
    info = _build.build_info()
    log(f"built {os.path.basename(info['path'])} in {info['seconds']:.2f} s "
        f"(wall {time.perf_counter() - t:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())


def _scan_sample(seed: int, num_points: int = 16000):
    """A synthetic scan, normalised and sampled the way ``predict_scan``
    does it."""
    import numpy as np

    from geot_tpu_torch.data.tooth_semi import _synthetic_scan, pc_norm

    pts, _ = _synthetic_scan(seed, 40000)
    norm, center, scale = pc_norm(pts)
    sel = np.random.default_rng(0).choice(len(norm), num_points,
                                          replace=False)
    return pts, np.ascontiguousarray(norm[sel]), center, scale


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` with no host time: ``reps``
    calls captured into one CUDA graph, replayed between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fps_bound(bound: Bound, B: int, N: int, npoint: int):
    return bound(9.0 * B * (npoint - 1) * N, B * N * 12 + B * npoint * 4)


def _kernels_fps(bound: Bound, pos, pos2, pos6, dup):
    """The cluster FPS: the card's cluster size, the exchange's per-step
    latency at each size, indices against ``fps_ref`` (and the one-block
    kernel), and both kernels' times in this run."""
    import importlib

    import torch

    from geot_tpu_torch import ops

    # the module: ``ops.fps`` is the function
    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    dev = pos.device
    max_active = fps_mod.card_max_active(dev)
    sizes = {B: fps_mod.card_cluster_size(dev, B) for B in (1, 2, 6)}
    C = sizes[1]
    log(f"fps_cluster: clusters the card runs at once by size {max_active}; "
        f"cluster size by batch {sizes} (the largest whose B clusters run "
        f"at once)")
    exchange = {}
    for c in [c for c in fps_mod.CLUSTER_SIZES[::-1] if max_active[c] > 0]:
        won = ops.cluster_exchange(1, 8192, c, dev)
        torch.cuda.synchronize()
        check(bool(((won >= 0) & (won < c)).all()),
              f"cluster_exchange C={c}: winners outside 0..{c - 1}")
        ms = cuda_ms(lambda: ops.cluster_exchange(1, 8192, c, dev), 3)
        exchange[f"C{c}"] = ms * 1e3 / 8191
    log("cluster exchange alone, 8191 steps, us per step: "
        + ", ".join(f"C = {k[1:]} {v:.3f}" for k, v in exchange.items()))

    B0, N0 = 1, 16000
    big = torch.randn((1, C * 256 * fps_mod.CLUSTER_SLOTS[-1] + 1, 3),
                      generator=torch.Generator().manual_seed(5)).to(dev)
    odd = pos[:, :12345].contiguous()
    err = 0
    for label, xyz, npoint in (("(1,16000,3)->8192", pos, 8192),
                               ("(2,16000,3)->8192", pos2, 8192),
                               ("(6,16000,3)->8192", pos6, 8192),
                               ("ties (1,5200,3)->2048", dup, 2048),
                               ("odd (1,12345,3)->3000", odd, 3000),
                               (f"oversized (1,{big.shape[1]},3)->300", big,
                                300)):
        plan = ops.fps_plan(xyz.shape[1],
                            fps_mod.card_cluster_size(dev, xyz.shape[0]))
        before = dict(ops.LAUNCHES)
        got = ops.fps(xyz, npoint)
        routed = sorted(k for k in ops.LAUNCHES
                        if ops.LAUNCHES[k] != before[k])
        # past the cluster's registers: the bucket kernel and its plan's
        # Morton launch, up to what its clusters hold
        want = ([plan.route] if plan.route == "fps_cluster" else
                ["fps_bucket", "morton"] if xyz.shape[1]
                <= ops.bucket_capacity(16) else ["fps"])
        check(routed == want, f"fps {label}: launched {routed}, plan "
              f"{plan}")
        ref = ops.fps_ref(xyz, npoint)
        block = ops.fps_block(xyz, npoint)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps {label}: indices differ from "
              f"fps_ref at {int((got != ref).sum())} places")
        err = max(err, int((got.long() - ref.long()).abs().max()))
        check(torch.equal(block, ref), f"fps_block {label}: indices differ "
              f"from fps_ref at {int((block != ref).sum())} places")
        log(f"fps {label}: route {want[0]} {plan[1:]}; indices bit-equal "
            f"to fps_ref, and so are fps_block's")

    # both kernels in turns (block, cluster, block); the cluster kernel at
    # the sizes the path takes and, where it fits, at half the B = 1 size
    timed = [c for c in dict.fromkeys((C, sizes[6], C // 2))
              if max_active.get(c, 0) > 0]
    rec_new, rec_old = {}, {}
    for label, xyz in (("(1,16000,3)->8192", pos), ("(6,16000,3)->8192",
                                                    pos6)):
        B = xyz.shape[0]
        t = {"fps_block": cuda_ms(lambda: ops.fps_block(xyz, 8192), 5)}
        for c in timed:
            plan = ops.fps_plan(N0, c)
            t[f"C{c}"] = cuda_ms(lambda: ops.fps_cluster(xyz, 8192, plan), 5)
        t["fps_block again"] = cuda_ms(lambda: ops.fps_block(xyz, 8192), 5)
        b_ms, b_by = _fps_bound(bound, B, N0, 8192)
        log(f"fps {label}: fps_cluster "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()
                        if k.startswith("C"))
            + f"; fps_block (one-block kernel) {t['fps_block']:.3f} / "
            f"{t['fps_block again']:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
        ms = t[f"C{sizes[B]}"]
        if B == B0:
            plain_ms = cuda_ms(lambda: ops.fps_ref(xyz, 8192), 1)
            rec_new = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "cluster_size": C,
                       "ms_by_cluster_size": {k: v for k, v in t.items()
                                              if k.startswith("C")},
                       "exchange_us_per_step": exchange}
            rec_old = {"ms": t["fps_block"], "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        else:
            rec_new["ms_b6"] = ms
            rec_old["ms_b6"] = t["fps_block"]
    rec_new["max_abs_err"] = rec_old["max_abs_err"] = float(err)
    return rec_new, rec_old


def _kernels_knn(bound: Bound, path_shapes, ties_case):
    """The split kNN against its plain version and the unsplit kernel at the
    serving path's 8 searches and a ties case; wrapper time (host
    included) and kernel-only time (CUDA graph) of both kernels."""
    import torch

    from geot_tpu_torch import ops

    err = 0.0
    # ms: kernel-only time; wrapper_ms: the wrapper's, host included
    new = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    old = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    t_ops = t_bytes = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, q, s, k in path_shapes + (ties_case,):
        d, i = ops.knn_split(q, s, k)
        d_r, i_r = ops.knn_small_k_ref(q, s, k)
        d_u, i_u = ops.knn_small_k_unsplit(q, s, k)
        d_p, i_p = ops.knn_small_k(q, s, k)           # the path's route
        torch.cuda.synchronize()
        B, Q, N = q.shape[0], q.shape[1], s.shape[1]
        shape = f"({Q},{N},{k})"
        for name, dd, ii in (("knn_small_k_ref", d_r, i_r),
                             ("knn_small_k_unsplit", d_u, i_u),
                             (f"knn_small_k ({ops.knn_route(Q, N)})", d_p,
                              i_p)):
            check(torch.equal(i, ii), f"knn {label} {shape}: idx differ from "
                  f"{name} at {int((i != ii).sum())} places")
            check(torch.equal(d, dd), f"knn {label} {shape}: d2 not "
                  f"bit-equal to {name}, max |diff| "
                  f"{float((d - dd).abs().max())}")
        err = max(err, float((d - d_r).abs().max()))
        S, split_len = ops.knn_split_plan(B, Q, N, sms)
        if label == "ties":
            log(f"knn ties {shape}: {S} splits; idx equal, d2 bit-equal to "
                f"the plain version and the unsplit kernel")
            continue
        t = {"split": cuda_ms(lambda: ops.knn_split(q, s, k), 20),
             "split_kernel": graph_ms(lambda: ops.knn_split(q, s, k), 20),
             "unsplit": cuda_ms(lambda: ops.knn_small_k_unsplit(q, s, k), 20),
             "unsplit_kernel": graph_ms(
                 lambda: ops.knn_small_k_unsplit(q, s, k), 20),
             "plain": cuda_ms(lambda: ops.knn_small_k_ref(q, s, k), 2)}
        flops, nbytes = 8.0 * B * Q * N, B * ((Q + N) * 12 + Q * k * 8)
        b_ms, b_by = bound(flops, nbytes)
        t_ops += flops
        t_bytes += nbytes
        for rec, w, kern in ((new, "split", "split_kernel"),
                             (old, "unsplit", "unsplit_kernel")):
            rec["wrapper_ms"] += t[w]
            rec["ms"] += t[kern]
            rec["plain_ms"] += t["plain"]
            rec["bound_ms"] += b_ms
        log(f"knn {label} {shape}: {S} splits of {split_len}; route "
            f"{ops.knn_route(Q, N)}; idx equal, d2 "
            f"bit-equal; split kernel {t['split_kernel']:.4f} ms (wrapper "
            f"{t['split']:.4f}), unsplit kernel {t['unsplit_kernel']:.4f} ms "
            f"(wrapper {t['unsplit']:.4f}), plain {t['plain']:.2f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    for rec in (new, old):
        rec["bound_by"] = bound(t_ops, t_bytes)[1]
        rec["max_abs_err"] = err
    log(f"knn per scan ({len(path_shapes)} searches): split kernel "
        f"{new['ms']:.4f} ms "
        f"(wrapper {new['wrapper_ms']:.4f}), unsplit kernel {old['ms']:.4f} ms "
        f"(wrapper {old['wrapper_ms']:.4f}), plain {new['plain_ms']:.2f} ms, bound "
        f"{new['bound_ms']:.4f} ms")
    return new, old


def _kernels_fast(bound: Bound, pos, pos6, full, world):
    """The serving topology's kernel shapes: ``fps_cluster`` for the
    true-FPS prefix of 1024 at B = 1 (a served scan) and B = 6 (the fast
    student) and on a duplicate-heavy cloud; ``knn_split`` at a fast scan's
    6 searches, on points in the stratified order."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops

    dev = pos.device
    # 2,000 distinct points sampled to 16,000 with replacement, as
    # predict_scan samples a small scan: min-distances reach 0 and the
    # smallest-index rule decides every later pick
    idx = np.random.default_rng(3).choice(2000, 16000, replace=True)
    dup = pos[:, torch.from_numpy(idx).to(dev)].contiguous()
    fps_rec = {}
    for label, xyz in (("(1,16000,3)->1024", pos),
                       ("(6,16000,3)->1024", pos6),
                       ("duplicate-heavy (1,16000 of 2000,3)->1024", dup)):
        B = xyz.shape[0]
        before = ops.LAUNCHES["fps_cluster"]
        got = ops.fps(xyz, 1024)
        check(ops.LAUNCHES["fps_cluster"] == before + 1,
              f"fps {label}: not routed to fps_cluster")
        ref = ops.fps_ref(xyz, 1024)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps {label}: indices differ from "
              f"fps_ref at {int((got != ref).sum())} places")
        msg = f"fps {label}: indices bit-equal to fps_ref"
        if not label.startswith("dup"):
            ms = cuda_ms(lambda: ops.fps(xyz, 1024), 10)
            b_ms, b_by = _fps_bound(bound, B, 16000, 1024)
            fps_rec[f"ms_b{B}"] = ms
            fps_rec[f"bound_ms_b{B}"] = b_ms
            fps_rec["bound_by"] = b_by
            msg += f"; {ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
            if B == 1:
                fps_rec["plain_ms_b1"] = cuda_ms(
                    lambda: ops.fps_ref(xyz, 1024), 1)
                msg += f", plain {fps_rec['plain_ms_b1']:.1f} ms"
        log(msg)

    perm = ops.fps_stratified(pos, 16000, 1024)
    sp = ops.gather_points(pos, perm)
    c512, c4096, c8192 = (sp[:, :n].contiguous() for n in (512, 4096, 8192))
    shapes = (("propagation_2 three_nn, rows 512-4095",
               sp[:, 512:4096].contiguous(), c512, 3),
              ("propagation_1 three_nn, rows 512-8191",
               sp[:, 512:8192].contiguous(), c512, 3),
              ("dgcnn_pro_2 cross", c4096, c512, 4),
              ("dgcnn_pro_1 cross", c8192, c4096, 4),
              ("propagation_0 three_nn, rows 8192-15999",
               sp[:, 8192:].contiguous(), c8192, 3),
              ("upsample three_nn", full, world, 3))
    ties = torch.cat([c8192, c8192[:, :3000]], dim=1).contiguous()
    knn_new, knn_old = _kernels_knn(bound, shapes,
                                    ("ties", sp[:, 8192:].contiguous(),
                                     ties, 3))
    return fps_rec, knn_new, knn_old


def _scan_searches(pts, pos, center, scale):
    """The exact serving path's 8 small-k searches on the points it gives
    them: ``((label, query, support, k), ...)``, the padded full scan and
    the sample in world coordinates."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine.eval import BUCKET, pad_to_bucket

    dev = pos.device
    fps_pts = ops.gather_points(pos, ops.fps(pos, 8192))
    c8192, c4096, c512 = (fps_pts[:, :n].contiguous()
                          for n in (8192, 4096, 512))
    full = torch.from_numpy(pad_to_bucket(pts, BUCKET))[None].to(dev)
    world = (pos * torch.tensor(np.float32(scale), device=dev)
             + torch.from_numpy(center).to(dev)).contiguous()
    return ((("propagation_2 three_nn", c4096, c512, 3),
             ("propagation_1 three_nn", c8192, c512, 3),
             ("dgcnn_pro_2 cross", c4096, c512, 4),
             ("dgcnn_pro_2 self", c4096, c4096, 4),
             ("dgcnn_pro_1 cross", c8192, c4096, 4),
             ("dgcnn_pro_1 self", c8192, c8192, 4),
             ("propagation_0 three_nn", pos, c8192, 3),
             ("upsample three_nn", full, world, 3)), full, world)


def phase_kernels(bound: Bound):
    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine.eval import BUCKET, pad_to_bucket

    log("phase 3: kernels against their plain versions")
    dev = torch.device("cuda")
    pts, pos0, center, scale = _scan_sample(11)
    pos = torch.from_numpy(pos0)[None].to(dev)                 # (1, 16000, 3)
    pos2 = torch.cat([pos, torch.from_numpy(_scan_sample(12)[1])[None]
                      .to(dev)], dim=0)                         # (2, 16000, 3)
    pos6 = torch.cat([pos2] + [
        torch.from_numpy(_scan_sample(s)[1])[None].to(dev)
        for s in (13, 14, 15, 16)]).contiguous()                # (6, 16000, 3)
    base = pos[:, :3000]
    dup = torch.cat([base, base[:, :1500], base[:, :700]], dim=1).contiguous()

    fps_rec, fpsblock_rec = _kernels_fps(bound, pos, pos2, pos6, dup)

    path_shapes, full, world = _scan_searches(pts, pos, center, scale)
    c4096 = path_shapes[0][1]
    ties = torch.cat([c4096, c4096[:, :1000]], dim=1).contiguous()
    knn_rec, knnu_rec = _kernels_knn(bound, path_shapes,
                                     ("ties", c4096, ties, 4))
    fast_fps, fast_knn, fast_knnu = _kernels_fast(bound, pos, pos6, full,
                                                  world)
    fps_rec["fast_prefix_1024"] = fast_fps
    knn_rec["fast_scan_6_searches"] = {
        k: fast_knn[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                 "bound_ms", "bound_by")}
    knnu_rec["fast_scan_6_searches"] = {
        k: fast_knnu[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                  "bound_ms", "bound_by")}
    for rec, extra in ((knn_rec, fast_knn), (knnu_rec, fast_knnu)):
        rec["max_abs_err"] = max(rec["max_abs_err"], extra["max_abs_err"])

    big = _big_scan()
    fpsb_rec = _kernels_pruned_fps(bound, pos, pos6, dup, big,
                                   fps_rec["plain_ms"])
    knnp_recs = _kernels_pruned_knn(bound, path_shapes, c4096, ties, big)
    return {"fps_cluster": fps_rec, "fps": fpsblock_rec,
            "knn_split": knn_rec, "knn_small_k": knnu_rec,
            "fps_bucket": fpsb_rec, **knnp_recs}


def _big_scan():
    """A whole 150,000-point scan, normalised as ``predict_scan`` does: its
    points (1, 150000, 3), its full-resolution upsample's queries padded to
    19 x 8,192 rows and 16,000 of them sampled, all on the card."""
    import numpy as np
    import torch

    from geot_tpu_torch.data.tooth_semi import _synthetic_scan, pc_norm
    from geot_tpu_torch.engine.eval import BUCKET, pad_to_bucket

    norm, _, _ = pc_norm(_synthetic_scan(306, 150000)[0])
    sel = np.random.default_rng(0).choice(len(norm), 16000, replace=False)
    return {"xyz": torch.from_numpy(norm)[None].cuda(),
            "full": torch.from_numpy(pad_to_bucket(norm, BUCKET))[None].cuda(),
            "sample": torch.from_numpy(
                np.ascontiguousarray(norm[sel]))[None].cuda()}


def _bucket_updates(dev, B: int, N: int, npoint: int):
    """fps_bucket's cluster size for B clouds of N points and its (step,
    bucket) updates if none were skipped: npoint - 1 steps of every real
    256-point bucket of its C blocks."""
    import importlib

    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    C = fps_mod.fps_bucket_size(fps_mod.card_bucket_max_active(dev), B, N)
    per = -(-N // C)
    buckets = B * sum(-(-max(0, min(N - r * per, per)) // fps_mod.BUCKET)
                      for r in range(C))
    return C, buckets * (npoint - 1)


def _kernels_pruned_fps(bound: Bound, pos, pos6, dup, big, plain_ms):
    """Kernel 3, ``fps_bucket``, bit-equal to its plain version and to the
    path's FPS kernels (``fps_cluster`` at 16,000 points; ``fps_block``, the
    route it replaced, at a 150,000-point scan), its skip share and times:
    kernel-only (the plan given), with its plan, and beside the path's
    kernel; two bounds: the brute-force one (every point every step) and
    the work done (9 operations for each point of each bucket updated)."""
    import torch

    from geot_tpu_torch import ops

    dev = pos.device
    rec = {}
    for label, xyz, npoint in (("(1,16000,3)->8192", pos, 8192),
                               ("(6,16000,3)->8192", pos6, 8192),
                               ("ties (1,5200,3)->2048", dup, 2048),
                               ("past the cluster (1,65537,3)->8192",
                                big["xyz"][:, :65537].contiguous(), 8192),
                               ("scan (1,150000,3)->8192", big["xyz"],
                                8192)):
        B, N, _ = xyz.shape
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        got = ops.fps_bucket(xyz, npoint, skipped=skipped)
        ref = ops.fps_bucket_ref(xyz, npoint)
        if N > 16 * 4096:        # past fps_cluster: the route is this kernel
            before = dict(ops.LAUNCHES)
            routed = ops.fps(xyz, npoint)
            grew = {k: ops.LAUNCHES[k] - before[k] for k in before}
            check(grew == dict(dict.fromkeys(grew, 0), fps_bucket=1,
                               morton=1), f"fps {label}: launched {grew}")
            path, path_name = ops.fps_block(xyz, npoint), "fps_block"
            torch.cuda.synchronize()
            check(torch.equal(routed, got), f"fps {label}: route differs")
        else:
            path, path_name = ops.fps(xyz, npoint), "fps_cluster"
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps_bucket {label}: indices differ "
              f"from fps_bucket_ref at {int((got != ref).sum())} places")
        check(torch.equal(got, path), f"fps_bucket {label}: indices differ "
              f"from {path_name} at {int((got != path).sum())} places")
        C, total = _bucket_updates(dev, B, N, npoint)
        share = int(skipped) / total
        brute_ms, brute_by = _fps_bound(bound, B, N, npoint)
        work_ms, work_by = bound(9.0 * (total - int(skipped)) * 256,
                                 B * N * 12 + B * npoint * 4)
        msg = (f"fps_bucket {label}: C = {C}; indices bit-equal to "
               f"fps_bucket_ref and {path_name}; bucket updates skipped "
               f"{int(skipped)}/{total} ({100 * share:.1f} %)")
        if not label.startswith("ties"):
            plan = ops.fps_bucket_plan(xyz)
            reps = 3
            t = {path_name: cuda_ms(lambda: (ops.fps_block(xyz, npoint)
                                             if path_name == "fps_block" else
                                             ops.fps(xyz, npoint)),
                                    1 if path_name == "fps_block" else reps),
                 "kernel": cuda_ms(lambda: ops.fps_bucket(xyz, npoint,
                                                          plan=plan), reps),
                 "with_plan": cuda_ms(lambda: ops.fps_bucket(xyz, npoint),
                                      reps),
                 "plan": graph_ms(lambda: ops.fps_bucket_plan(xyz), 10)}
            t["kernel again"] = cuda_ms(
                lambda: ops.fps_bucket(xyz, npoint, plan=plan), reps)
            # the route takes this kernel only past the cluster, and there
            # it must beat the one-block kernel it replaced
            check(path_name == "fps_cluster" or t["with_plan"]
                  < t[path_name], f"fps_bucket {label}: slower than "
                  f"{path_name} with its plan")
            msg += (f"; kernel {t['kernel']:.3f} / {t['kernel again']:.3f} "
                    f"ms, with plan {t['with_plan']:.3f} ms (plan "
                    f"{t['plan']:.4f}), {path_name} {t[path_name]:.3f} ms; "
                    f"bound of the work done {work_ms:.5f} ms ({work_by}; "
                    f"the kernel at {100 * work_ms / t['kernel']:.2f} % of "
                    f"it), brute-force bound {brute_ms:.4f} ms ({brute_by}; "
                    f"{100 * brute_ms / t['kernel']:.2f} %)")
            row = {"ms": t["kernel"], "with_plan_ms": t["with_plan"],
                   "plan_ms": t["plan"], f"{path_name}_ms": t[path_name],
                   "bound_ms": work_ms, "bound_by": work_by,
                   "brute_force_bound_ms": brute_ms,
                   "brute_force_bound_by": brute_by, "skip_share": share,
                   "cluster_size": C}
            if label.startswith("(1,"):
                rec = dict(row, plain_ms=plain_ms, max_abs_err=0.0)
            elif label.startswith("(6,"):
                rec["b6"] = row
            elif label.startswith("past"):
                rec["past_cluster_65537"] = row
            else:
                rec["scan_150000"] = row
        log(msg)
    return rec


def _knn_work(bound: Bound, B, Q, N, k, skipped):
    """The pruned kNN's two bounds: brute force (8 operations for every
    (query, support) pair) and the work done (the pairs of the (32-query
    tile, 128-support chunk) pairs visited, counted as whole ones)."""
    nbytes = B * ((Q + N) * 12 + Q * k * 8)
    pairs = B * -(-Q // 32) * -(-N // 128)
    return (bound(8.0 * B * Q * N, nbytes),
            bound(8.0 * (pairs - skipped) * 32 * 128, nbytes),
            skipped / pairs)


def _kernels_plan(bound: Bound, q, s_):
    """The pruned kNN's plan kernels at the upsample's clouds, each against
    its plain version: the Morton codes of both clouds (one launch) and
    the sorted support rows with their chunk boxes; times from CUDA
    graphs; bounds: bytes, each input read once and each output written
    once."""
    import torch

    from geot_tpu_torch import ops

    Q, N = q.shape[1], s_.shape[1]
    codes = ops.morton_codes_kernel(q, s_)
    order = ops.knn_pruned_order(q, s_)
    s4, boxes = ops.knn_pruned_prepare(s_, order[:, Q:], base=Q)
    torch.cuda.synchronize()
    check(torch.equal(codes, ops.morton_codes_joint(q, s_))
          and torch.equal(order, torch.sort(ops.morton_codes_joint(q, s_),
                                            dim=-1, stable=True).indices),
          "morton: codes differ from morton_codes")
    for got, want in zip((s4, boxes), ops.knn_pruned_prepare_ref(
            s_, order[:, Q:], base=Q)):
        check(torch.equal(got, want), "knn_pruned_prepare differs from its "
              "plain version")
    NC = boxes.shape[1]
    rec = {"morton": {
        "ms": graph_ms(lambda: ops.morton_codes_kernel(q, s_), 10),
        "plain_ms": cuda_ms(lambda: ops.morton_codes_joint(q, s_), 10),
        "max_abs_err": 0.0},
        "knn_pruned_prepare": {
        "ms": graph_ms(lambda: ops.knn_pruned_prepare(s_, order[:, Q:],
                                                      base=Q), 10),
        "plain_ms": cuda_ms(lambda: ops.knn_pruned_prepare_ref(
            s_, order[:, Q:], base=Q), 10),
        "max_abs_err": 0.0},
        "sort_ms": graph_ms(lambda: torch.sort(codes, dim=-1, stable=True),
                            10)}
    rec["morton"]["bound_ms"], rec["morton"]["bound_by"] = bound(
        0.0, (Q + N) * 16)
    rec["knn_pruned_prepare"]["bound_ms"], \
        rec["knn_pruned_prepare"]["bound_by"] = bound(
            0.0, N * (12 + 8 + 16) + NC * 32)
    log(f"the plan at ({Q},{N}): Morton codes of both clouds "
        f"{rec['morton']['ms']:.4f} ms (plain {rec['morton']['plain_ms']:.4f}"
        f", bound {rec['morton']['bound_ms']:.5f}), their one stable sort "
        f"{rec['sort_ms']:.4f} ms, the sorted rows and chunk boxes "
        f"{rec['knn_pruned_prepare']['ms']:.4f} ms (plain "
        f"{rec['knn_pruned_prepare']['plain_ms']:.4f}, bound "
        f"{rec['knn_pruned_prepare']['bound_ms']:.5f}); both bit-equal to "
        f"their plain versions")
    sort_ms = rec.pop("sort_ms")
    rec["morton"]["sort_after_it_ms"] = sort_ms
    return rec


def _kernels_pruned_knn(bound: Bound, path_shapes, c4096, ties, big):
    """Kernel 4, ``knn_small_k_pruned``, and its plan's kernels (Morton
    codes, the sorted supports and chunk boxes): bit-equal to the plain
    version and to ``knn_split`` at a scan's 8 searches, ties, the two
    upsamples (a 40,000-point scan's and a 150,000-point scan's) and
    ``knn_route``'s crossover shapes; per search its kernel-only time (a
    CUDA graph, the plan given), with its plan (a graph of the wrapper, and
    the wrapper with the host, the median of 7 runs of 10 calls),
    ``knn_split``'s (the same two ways), the skip share and two bounds
    (brute force, and the pairs visited)."""
    import torch

    from geot_tpu_torch import ops

    dev = c4096.device
    shapes = path_shapes + (("ties", c4096, ties, 4),
                            ("upsample of a 150,000-point scan", big["full"],
                             big["sample"], 3))
    path_labels = [x[0] for x in path_shapes]
    cross = (("self-search (2,16000)x(2,16000)", None, None, 2),
             ("crossover (24576,16000)", big["full"][:, :24576].contiguous(),
              big["sample"], 3),
             ("crossover (32768,16000)", big["full"][:, :32768].contiguous(),
              big["sample"], 3))
    scan8 = {"ms": 0.0, "with_plan_ms": 0.0, "wrapper_ms": 0.0,
             "knn_split_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
             "brute_force_bound_ms": 0.0}
    n_skip = n_pairs = 0
    out = {}
    for label, q, s_, k in shapes + cross:
        if q is None:               # the top2 loss's self-search, 2 clouds
            q = s_ = torch.cat([path_shapes[-2][1], torch.flip(
                path_shapes[-2][1], dims=[1])]).contiguous()
        B, Q, N = q.shape[0], q.shape[1], s_.shape[1]
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        d, i = ops.knn_small_k_pruned(q, s_, k, skipped=skipped)
        d_r, i_r = ops.knn_small_k_pruned_ref(q, s_, k)
        d_s, i_s = ops.knn_split(q, s_, k)
        d_p, i_p = ops.knn_small_k(q, s_, k)
        torch.cuda.synchronize()
        shape = f"({Q},{N},{k})"
        route = ops.knn_route(Q, N)
        for name, dd, ii in (("knn_small_k_pruned_ref", d_r, i_r),
                             ("knn_split", d_s, i_s),
                             (f"knn_small_k ({route})", d_p, i_p)):
            check(torch.equal(i, ii), f"knn_small_k_pruned {label} {shape}: "
                  f"idx differ from {name} at {int((i != ii).sum())} places")
            check(torch.equal(d, dd), f"knn_small_k_pruned {label} {shape}: "
                  f"d2 not bit-equal to {name}")
        (brute_ms, brute_by), (work_ms, work_by), share = _knn_work(
            bound, B, Q, N, k, int(skipped))
        msg = (f"knn_small_k_pruned {label} {shape}: idx equal, d2 bit-equal "
               f"to the plain version, knn_split and the route ({route}); "
               f"(tile, chunk) pairs skipped {100 * share:.1f} %")
        if label != "ties":
            plan = ops.knn_pruned_plan(q, s_)
            t = {"kernel": graph_ms(lambda: ops.knn_small_k_pruned(
                     q, s_, k, plan=plan), 10),
                 "with_plan": graph_ms(lambda: ops.knn_small_k_pruned(
                     q, s_, k), 10),
                 "wrapper": cuda_ms_median(lambda: ops.knn_small_k_pruned(
                     q, s_, k), 10),
                 "split": graph_ms(lambda: ops.knn_split(q, s_, k), 10),
                 "split_wrapper": cuda_ms_median(
                     lambda: ops.knn_split(q, s_, k), 10),
                 "plan": graph_ms(lambda: ops.knn_pruned_plan(q, s_), 10),
                 "morton": graph_ms(lambda: ops.morton_codes_kernel(q, s_),
                                    10),
                 "plain": cuda_ms(lambda: ops.knn_small_k_pruned_ref(
                     q, s_, k), 1)}
            faster = t["with_plan"] < t["split"] and \
                t["wrapper"] < t["split_wrapper"]
            msg += (f"; kernel {t['kernel']:.4f} ms, with plan "
                    f"{t['with_plan']:.4f} (plan {t['plan']:.4f}, its Morton "
                    f"launch {t['morton']:.4f}; wrapper {t['wrapper']:.4f}); "
                    f"knn_split {t['split']:.4f} (wrapper "
                    f"{t['split_wrapper']:.4f}): the pruned kernel with its "
                    f"plan is {'faster' if faster else 'slower'}; plain "
                    f"{t['plain']:.2f} ms; bound of the pairs visited "
                    f"{work_ms:.5f} ms ({work_by}; the kernel at "
                    f"{100 * work_ms / t['kernel']:.2f} % of it), brute-force "
                    f"bound {brute_ms:.5f} ms ({brute_by}; "
                    f"{100 * brute_ms / t['kernel']:.2f} %)")
            row = {"ms": t["kernel"], "with_plan_ms": t["with_plan"],
                   "wrapper_ms": t["wrapper"], "plan_ms": t["plan"],
                   "morton_ms": t["morton"], "knn_split_ms": t["split"],
                   "knn_split_wrapper_ms": t["split_wrapper"],
                   "plain_ms": t["plain"], "bound_ms": work_ms,
                   "bound_by": work_by, "brute_force_bound_ms": brute_ms,
                   "brute_force_bound_by": brute_by, "skip_share": share,
                   "knn_route": route, "faster_with_plan": faster}
            # the route takes the pruned kernel only where it is faster
            check(faster or route == "knn_split", f"{label}: the route takes "
                  f"the pruned kernel, slower here with its plan")
            if label in path_labels:
                for key, src in (("ms", "kernel"), ("with_plan_ms",
                                                    "with_plan"),
                                 ("wrapper_ms", "wrapper"),
                                 ("knn_split_ms", "split"),
                                 ("plain_ms", "plain")):
                    scan8[key] += t[src]
                scan8["bound_ms"] += work_ms
                scan8["brute_force_bound_ms"] += brute_ms
                n_skip += int(skipped)
                n_pairs += B * -(-Q // 32) * -(-N // 128)
            if label.startswith("upsample three_nn"):
                out["knn_small_k_pruned"] = dict(row, max_abs_err=0.0)
                out.update(_kernels_plan(bound, q, s_))
            elif label.startswith("upsample of a 150"):
                out.setdefault("knn_small_k_pruned", {})["scan_150000"] = row
            elif label not in path_labels:
                out.setdefault("crossover", {})[label] = row
        log(msg)
    scan8["skip_share"] = n_skip / n_pairs
    out["knn_small_k_pruned"]["scan_8_searches"] = scan8
    out["knn_small_k_pruned"]["crossover"] = out.pop("crossover")
    log(f"knn_small_k_pruned over a scan's 8 searches: kernel "
        f"{scan8['ms']:.4f} ms, with plan {scan8['with_plan_ms']:.4f} ms "
        f"(wrapper {scan8['wrapper_ms']:.4f}); knn_split "
        f"{scan8['knn_split_ms']:.4f} ms; bound of the pairs visited {scan8['bound_ms']:.5f} ms, "
        f"brute-force bound {scan8['brute_force_bound_ms']:.4f} ms; pairs "
        f"skipped {100 * scan8['skip_share']:.1f} %")
    return out


def _fdi_ok(labels, jaw: int) -> bool:
    lo, hi = (31, 48) if jaw == 0 else (11, 28)
    return all(lab == 0 or lo <= lab <= hi for lab in labels)


def phase_serving():
    import copy

    import numpy as np
    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, ops
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan
    from geot_tpu_torch.engine.predict import (load_model, map_pred_to_fdi,
                                               predict_scan)

    log("phase 4: serving the flagship model")
    model = load_model(FLAGSHIP_SEG_ARGS, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    scans = [_synthetic_scan(seed, 40000)[0] for seed in (21, 22, 23)]
    predict_scan(model, scans[0], jaw=0)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    results, lat = [], []
    for n, pts in enumerate(scans):
        jaw = n % 2
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        pred, logits = predict_scan(model, pts, jaw=jaw)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        grew = {k: ops.LAUNCHES[k] - before[k] for k in before}
        check(grew == _with_upsamples(dict(
            dict.fromkeys(ops.LAUNCHES, 0), fps_cluster=1, knn_split=7), 1),
              f"scan {n}: kernel launches {grew}, expected 1 fps_cluster + "
              f"7 knn_split + the upsample's {UPSAMPLE}")
        check(logits.shape == (16000, 17) and bool(torch.isfinite(logits).all()),
              f"scan {n}: logits {tuple(logits.shape)} not finite/shaped")
        labels = map_pred_to_fdi(pred, jaw)
        check(pred.shape == (len(pts),) and pred.dtype == np.uint8
              and _fdi_ok(labels, jaw), f"scan {n}: bad labels")
        results.append(labels)
    launches = dict(ops.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"served 3 scans of 40000 points ({n_params} parameters): latency "
        f"{', '.join(f'{x:.1f}' for x in lat)} ms; peak memory "
        f"{peak_mb:.0f} MiB; launches {launches}")

    # the card's forward (kernels) against the same model on the CPU (plain
    # versions), same sampled input
    pos = torch.from_numpy(_scan_sample(21)[1])[None]
    cls = torch.zeros((1, 1), dtype=torch.long)
    with torch.no_grad():
        a = model({"pos": pos.cuda(), "x": None, "cls": cls.cuda()})[0].cpu()
        cpu_model = copy.deepcopy(model).cpu()
        b = cpu_model({"pos": pos, "x": None, "cls": cls})[0]
    diff = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    scale = max(1.0, float(b.abs().max()))
    log(f"card vs CPU forward at full width: max |dlogit| {diff:.3e} "
        f"(logit scale {scale:.2f}), argmax agreement {agree:.6f}")
    check(diff <= 1e-3 * scale and agree >= 0.999,
          "card forward disagrees with the CPU forward")
    return scans, results, launches, lat, peak_mb


def _profile(label: str, fn, reps: int, top: int = 15):
    """Device time by kernel over ``reps`` calls of ``fn`` after a warm-up,
    and the device's busy share of the wall time; returns (wall ms, device
    busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # kernels only: operator rows repeat the time of the kernels they launch
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    # the host's operator calls, nested ones included
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::")) / reps
    log(f"{label} x {reps}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} %), idle "
        f"{100 * (1 - busy_us / wall_us):.1f} %; {n_ops:.0f} aten calls a "
        f"call on the host, {wall_us / reps / max(n_ops, 1):.2f} us of wall "
        f"each")
    for e in rows[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  "
            f"{e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3


def phase_profile(scans, train):
    """``--profile``: where the time of a served scan and of a train step
    goes on the device."""
    from geot_tpu_torch.data.build import MODEL_KEYS, SEMI_KEYS, to_device
    from geot_tpu_torch.engine.predict import load_model, predict_scan
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step
    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG

    log("phase 7: profile")
    model = load_model(seed=0, device="cuda")
    it = iter(scans * 2)
    _profile("served scan", lambda: predict_scan(model, next(it)), 3)
    state, (bl, bu) = train["state"], train["pairs"][0]
    bl = to_device(bl, MODEL_KEYS, "cuda")
    bu = to_device(bu, SEMI_KEYS, "cuda")
    step = make_semi_step(FLAGSHIP_SEMI_CFG)
    _profile("train step", lambda: step(state, bl, bu, 1e-3, True), 2)
    # the _fast.yaml step: a student in the serving topology, the exact
    # teacher
    fast = SemiTrainState.create(
        FLAGSHIP_SEMI_CFG, seg_args=dict(FLAGSHIP_SEG_ARGS, **FAST),
        teacher_args=FLAGSHIP_SEG_ARGS, seed=0, device="cuda")
    fast.cm = state.cm
    _profile("fast train step", lambda: step(fast, bl, bu, 1e-3, True), 2)


def phase_http(scans, results):
    import numpy as np

    from geot_tpu_torch.engine.serve import serve

    log("phase 5: http")
    httpd = serve(port=0, device="cuda", seed=0, warmup=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            check(json.load(r)["status"] == "ok", "healthz")
        for n, pts in enumerate(scans):
            jaw = n % 2
            buf = io.BytesIO()
            np.save(buf, pts)
            req = urllib.request.Request(
                f"{base}/predict?jaw={'lower' if jaw == 0 else 'upper'}",
                data=buf.getvalue(), method="POST")
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                d = json.load(r)
            dt = (time.perf_counter() - t) * 1e3
            same = float(np.mean(np.asarray(d["labels"]) ==
                                 np.asarray(results[n])))
            check(d["n_points"] == len(pts) and _fdi_ok(d["labels"], jaw)
                  and same >= 0.999, f"http scan {n}: bad answer "
                  f"(agreement with predict_scan {same})")
            log(f"POST /predict scan {n}: {dt:.1f} ms round trip, labels "
                f"agree with predict_scan {same:.6f}")
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            check(json.load(r)["scans_served"] == 3, "scans_served")
    finally:
        httpd.shutdown()
        httpd.server_close()


# biases that feed a batch-statistics BatchNorm: their gradient is zero in
# exact arithmetic, so only its size is checked
_ZERO_GRAD = ("segmentor.encoder.first_conv.0.bias",
              "segmentor.encoder.first_conv.3.bias",
              "segmentor.encoder.second_conv.0.bias",
              "segmentor.seg_head.0.bias")


def _adam_grads(state):
    """name -> the first AdamW moment after one step (0.1 x the clipped
    gradient), on the host."""
    out = {}
    for name, p in list(state.model.named_parameters()) + list(
            state.t_predictor.named_parameters()):
        opt = state.t_opt if name.startswith("T_predictor.") else state.opt
        out[name] = opt.state[p]["exp_avg"].detach().double().cpu()
    return out


def phase_train():
    """The flagship semi-supervised step at full width: returns the
    per-step launch counts and numbers for the kernels line."""

    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data.build import (MODEL_KEYS, SEMI_KEYS,
                                           build_semi_loaders, semi_pairs,
                                           to_device)
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_cm_step, make_semi_step
    from geot_tpu_torch.engine.train import cal_mean_feature
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    log("phase 6: train (flagship FixMatch + NTM step, full width)")
    dev = torch.device("cuda")
    cfg = FLAGSHIP_SEMI_CFG
    C = cfg["num_classes"]
    t = time.perf_counter()
    state = SemiTrainState.create(cfg, seed=0, device=dev)
    loader_l, loader_u = build_semi_loaders(cfg)
    epoch = 1
    for loader in (loader_l, loader_u):
        loader.set_epoch(epoch)
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"state built in {time.perf_counter() - t:.1f} s: student "
        f"{n_params} parameters, batch {cfg['batch_size_l']} + "
        f"{cfg['batch_size_u']} + {cfg['batch_size_u']}, "
        f"{cfg['num_points']} points")

    # cm bootstrap over 2 labelled batches, counted per batch
    cm_step = make_cm_step()
    counted = []

    def counting_step(model, batch):
        ops.reset_launches()
        out = cm_step(model, batch)
        counted.append(dict(ops.LAUNCHES))
        return out

    pairs = list(semi_pairs(loader_l, loader_u, limit=3))
    t = time.perf_counter()
    state.cm = cal_mean_feature(counting_step, state.model,
                                [b for b, _ in pairs[:2]], C, dev)
    torch.cuda.synchronize()
    log(f"cal_mean_feature over 2 batches: {time.perf_counter() - t:.2f} s; "
        f"launches per batch {counted}")
    for c in counted:
        check(c == dict(dict.fromkeys(ops.LAUNCHES, 0), fps_cluster=1,
                        knn_split=7),
              f"cm batch launches {c}, expected 1 fps_cluster + 7 "
              f"knn_split")
    check(bool(torch.isfinite(state.cm).all()), "cm not finite")

    step = make_semi_step(cfg)
    lr = build_scheduler_from_cfg(cfg)(epoch)
    use_teacher = cfg["supervised_epochs"] < epoch <= cfg["switch_ep"]
    check(use_teacher, "epoch 1 of the flagship runs the teacher")
    before = {k: v.detach().clone()
              for k, v in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, per_step = [], []
    for n, (bl, bu) in enumerate(pairs):
        bl = to_device(bl, MODEL_KEYS, dev)
        bu = to_device(bu, SEMI_KEYS, dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        m = step(state, bl, bu, lr, use_teacher)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(dict(ops.LAUNCHES))
        terms = {k: float(m[k]) for k in ("loss", "sup_loss", "unsup_loss",
                                          "threed_loss")}
        log(f"step {n}: {step_ms[-1]:.1f} ms; " + ", ".join(
            f"{k} {v:.6f}" for k, v in terms.items())
            + f"; teacher_acc {float(m['teacher_acc']):.4f}; launches "
            f"{per_step[-1]}")
        check(all(math.isfinite(v) for v in terms.values()),
              f"step {n}: a loss is not finite: {terms}")
        check(per_step[-1] == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                   fps_cluster=2, knn_split=14),
              f"step {n}: launches {per_step[-1]}, expected 2 fps_cluster "
              f"+ 14 knn_split")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    rows = state.ema_t.sum(dim=1)
    check(bool(torch.allclose(rows, torch.ones_like(rows), atol=1e-5)),
          f"ema_t rows do not sum to 1: {rows.tolist()}")
    changed = sum(not torch.equal(before[k], v)
                  for k, v in state.model.named_parameters())
    check(changed > 0.9 * len(before), f"only {changed}/{len(before)} "
          f"parameter tensors changed")
    check(state.step == 3, "step counter")
    # the last step's (clipped) gradients, for phase 16's optimizers
    grads = {n: p.grad.detach().clone()
             for n, p in state.model.named_parameters()}
    log(f"3 steps: {', '.join(f'{x:.1f}' for x in step_ms)} ms; peak memory "
        f"{peak_mb:.0f} MiB; {changed}/{len(before)} parameter tensors "
        f"changed; ema_t rows sum to 1")

    # card vs CPU: one step from the same state and batch, 1 + 1 + 1
    # clouds, CMP_TRUNK; in float32, and in float64 (the model and step in
    # float64 around the float32 kernels), where rounding no longer hides
    # what the two paths compute. The CPU's float64 step finds its
    # float32 searches' results in cpu_search_memo
    cfg1 = dict(cfg, batch_size_l=1, batch_size_u=1)
    seg = dict(FLAGSHIP_SEG_ARGS, **CMP_TRUNK)
    l1, u1 = build_semi_loaders(cfg1)
    for loader in (l1, u1):
        loader.set_epoch(epoch)
    bl, bu = next(semi_pairs(l1, u1, limit=1))
    compare = {}
    # float32 gradients through batch-statistics BatchNorm differ by up to
    # ~1e-2 of a tensor's scale between two summation orders (PERF.md); the
    # float32 bound only guards against gross errors, float64 holds 1e-3
    for dt, grad_tol in ((torch.float32, 5e-2), (torch.float64, 1e-3)):
        res = {}
        for name in ("cuda", "cpu"):
            st = SemiTrainState.create(cfg1, seg_args=seg, seed=1,
                                       device=name)
            for mod in (st.model, st.teacher, st.t_predictor):
                mod.to(dt)
            st.ema_t = st.ema_t.to(dt)
            st.cm = state.cm.to(name, dt)
            batches = [{k: (v.to(dt) if v.is_floating_point() else v)
                        for k, v in to_device(b, keys, name).items()}
                       for b, keys in ((bl, MODEL_KEYS), (bu, SEMI_KEYS))]
            t = time.perf_counter()
            seen = dict(_SEARCH_STATS)
            with cpu_search_memo():
                m = make_semi_step(cfg1)(st, *batches, lr, True)
            if name == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t
            res[name] = ({k: float(m[k]) for k in (
                "loss", "sup_loss", "unsup_loss", "threed_loss")},
                _adam_grads(st), st.ema_t.double().cpu())
            log(f"one {str(dt)[6:]} step, 1 + 1 + 1 clouds, on the {name}: "
                f"{secs:.1f} s; losses {res[name][0]}; CPU searches "
                + ", ".join(f"{k} {v - seen[k]}"
                            for k, v in _SEARCH_STATS.items()))
        (lg, gg, eg), (lc, gc, ec) = res["cuda"], res["cpu"]
        rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lg}
        gmax = max(float(v.abs().max()) for v in gc.values())
        errs = {}
        for k, ref in gc.items():
            if k in _ZERO_GRAD:
                check(float(gg[k].abs().max()) <= 1e-4 * gmax
                      and float(ref.abs().max()) <= 1e-4 * gmax,
                      f"{k}: gradient should vanish")
                continue
            scale = float(ref.abs().max())
            errs[k] = (float((gg[k] - ref).abs().max()) / scale if scale > 0
                       else float(gg[k].abs().max()))
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        ema_diff = float((eg - ec).abs().max())
        log(f"card vs CPU {str(dt)[6:]} step: loss terms relative "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + "; per-tensor gradient max |d| / max |g|: worst "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst)
            + f" ({len(errs)} tensors); ema_t max |d| {ema_diff:.2e}")
        check(all(v <= 1e-4 for v in rel.values()),
              f"card vs CPU {dt} loss terms differ: {rel}")
        check(worst[0][1] <= grad_tol,
              f"card vs CPU {dt} gradients differ: {worst}")
        check(ema_diff <= 1e-6, f"card vs CPU {dt} ema_t differ")
        compare[str(dt)[6:]] = {"loss_rel": max(rel.values()),
                                "grad_rel": worst[0][1]}
    return {"step_ms": step_ms, "peak_mb": peak_mb, "per_step": per_step,
            "grads": grads,
            "compare": compare,
            # the float64 CPU step (the last of the loop) and its inputs,
            # which phase 18 holds WholePartSeg_ntm's card step against
            "semi64_ref": {"cpu": res["cpu"], "cm": state.cm.detach().cpu(),
                           "lr": lr},
            "cm_batches": counted, "state": state, "pairs": pairs}


# the trainer's expected kernel launches: per semi step, per cm-bootstrap
# batch, per val/test batch of 2 scans (the batched forward + one
# full-resolution upsample per scan of 40,000 points)
_PER_STEP = {"fps_cluster": 2, "knn_split": 14}
_PER_CM_BATCH = {"fps_cluster": 1, "knn_split": 7}
_PER_EVAL_BATCH = _with_upsamples({"fps_cluster": 1, "knn_split": 7}, 2)
# epoch-2 scalars of a resume (run B) against the uninterrupted run A, with
# the card's default, non-deterministic backward (atomics): loss terms
# relative, val/test metrics absolute. Each loss term's bound is the spread
# of that term between uninterrupted runs of the same seed: the largest
# |y - x| / |x| over every pair of the 16 runs of ``--resume-spread 8``
# (PERF.md section 6; an H100 at 700 W). insT_threed_loss (the
# T-predictor's term) takes one of two values, ~0.005 or ~0.0095, run to
# run, so its spread (1.20) says nothing of the resume; the resume's own
# test is the deterministic pair (``resume_check``): bit-equal.
RESUME_LOSS_RTOL = {"train_loss": 0.0421, "train_loss_l": 0.0373,
                    "train_loss_u": 0.0247, "insT_threed_loss": 1.21}
RESUME_METRIC_ATOL = 5e-3


def _expected(steps: int, cm_batches: int, eval_batches: int):
    from geot_tpu_torch import ops

    out = dict.fromkeys(ops.LAUNCHES, 0)
    for per, n in ((_PER_STEP, steps), (_PER_CM_BATCH, cm_batches),
                   (_PER_EVAL_BATCH, eval_batches)):
        for k, v in per.items():
            out[k] += v * n
    return out


def _epoch_scalars(path: str, skip: int = 0):
    """tag -> value of the epoch-2 lines of a scalars.jsonl, from line
    ``skip`` on; and the file's line count."""
    with open(path) as f:
        lines = f.readlines()
    out = {}
    for line in lines[skip:]:
        d = json.loads(line)
        if d["step"] == 2:
            out[d["tag"]] = d["value"]
    return out, len(lines)


def phase_trainer():
    """The training entry point on the card: ``parse_and_run`` on the
    flagship YAML at full width, in-process so the launch counters can be
    read. Run A trains 2 epochs (val every epoch, test at epoch 2,
    checkpoints every epoch), run C scores A's best checkpoint in
    ``mode=val``, run B resumes from A's epoch-1 checkpoint to epoch 2."""
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path

    log("phase 8: trainer (parse_and_run, flagship YAML, full width)")
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    root = tempfile.mkdtemp(prefix="geot_trainer_")
    # (run, what, ms) of every validate, save and load, each between two
    # synchronisations
    timed = {"validate": [], "save": [], "load": []}
    current = {"run": "A"}
    real = {k: getattr(train_mod, k) for k in ("validate", "save_checkpoint",
                                               "load_checkpoint")}

    def timing(name, fn, what):
        def run(*args, **kwargs):
            label = what(args, kwargs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timed[name].append((current["run"], label,
                                (time.perf_counter() - t) * 1e3))
            return out
        return run

    # a validate call on a loader without a cache is its first pass: it
    # builds the items on the host and copies them to the card
    train_mod.validate = timing(
        "validate", real["validate"],
        lambda a, k: (k.get("tag", "val"), len(a[2].dataset),
                      getattr(a[2], "_geot_eval_cache", None) is None))
    train_mod.save_checkpoint = timing("save", real["save_checkpoint"],
                                       lambda a, k: f"epoch {a[2]}")
    train_mod.load_checkpoint = timing("load", real["load_checkpoint"],
                                       lambda a, k: os.path.basename(a[0]))
    common = [f"root_dir={root}", "val_freq=1", "test_freq=2", "save_freq=1"]
    try:
        # run A
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t = time.perf_counter()
        res_a = train_mod.parse_and_run(["--cfg", cfg_path, "epochs=2",
                                         *common])
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t
        launches_a = dict(ops.LAUNCHES)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        run_dirs = [os.path.join(root, "tooth_semi", d)
                    for d in os.listdir(os.path.join(root, "tooth_semi"))]
        check(len(run_dirs) == 1, f"run A made {run_dirs}")
        run_dir = run_dirs[0]
        name = os.path.basename(run_dir)
        ckdir = os.path.join(run_dir, "checkpoint")
        for tag in ("latest", "best", "E1", "E2"):
            check(os.path.exists(ckpt_path(ckdir, name, tag)),
                  f"run A: no {tag} checkpoint in {os.listdir(ckdir)}")
        scalars = os.path.join(run_dir, "scalars.jsonl")
        a2, n_lines = _epoch_scalars(scalars)
        missing = [t for t in list(train_mod.REF_TAGS)[:9]
                   + ["insT_threed_loss"] if t not in a2]
        check(not missing, f"run A: scalars.jsonl lacks {missing}")
        losses = {t: a2[t] for t in ("train_loss", "train_loss_l",
                                     "train_loss_u", "insT_threed_loss")}
        check(all(math.isfinite(v) for v in losses.values()),
              f"run A: epoch-2 losses not finite: {losses}")
        for split in ("val", "test"):
            bad = {k: v for k, v in res_a[split].items()
                   if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
            check(not bad, f"run A: {split} metrics outside [0, 1]: {bad}")
        want = _expected(steps=24, cm_batches=12, eval_batches=3 * 12)
        check(launches_a == want, f"run A launches {launches_a}, expected "
              f"{want} (24 steps, 12 cm batches, 3 eval passes of 12)")
        epochs = {}
        with open(scalars) as f:
            for line in f:
                d = json.loads(line)
                if d["tag"] in ("epoch_seconds", "data_seconds"):
                    epochs.setdefault(d["step"], {})[d["tag"]] = d["value"]
        with open(os.path.join(run_dir, "step_times.jsonl")) as f:
            steps = [json.loads(x) for x in f]
        step_ms = [s_["dt"] * 1e3 for s_ in steps if s_["step"] % 12 != 1]
        ckpt_bytes = os.path.getsize(ckpt_path(ckdir, name, "latest"))

        # run C: mode=val on A's best checkpoint
        current["run"] = "C"
        ops.reset_launches()
        res_c = train_mod.parse_and_run(
            ["--cfg", cfg_path, "mode=val",
             f"pretrained_path={ckpt_path(ckdir, name, 'best')}",
             f"root_dir={root}"])
        launches_c = dict(ops.LAUNCHES)
        best = res_a["best"]
        diff_c = max(abs(res_c["val"][f"whole_{k}"] - best[k])
                     for k in ("miou", "dsc", "acc"))
        log(f"run C (mode=val, best checkpoint of epoch {best['epoch']}): "
            f"whole miou/dsc/acc {res_c['val']['whole_miou']:.6f} / "
            f"{res_c['val']['whole_dsc']:.6f} / "
            f"{res_c['val']['whole_acc']:.6f}; run A's best "
            f"{best['miou']:.6f} / {best['dsc']:.6f} / {best['acc']:.6f}; "
            f"max |d| {diff_c:.3e}; launches {launches_c}")
        check(diff_c <= 1e-6, "run C does not give run A's best val metrics")
        check(launches_c == _expected(0, 0, 12), f"run C launches "
              f"{launches_c}")

        # run B: resume from A's epoch-1 checkpoint to epoch 2
        current["run"] = "B"
        ops.reset_launches()
        train_mod.parse_and_run(
            ["--cfg", cfg_path, "mode=resume",
             f"pretrained_path={ckpt_path(ckdir, name, 'E1')}", "epochs=2",
             *common])
        launches_b = dict(ops.LAUNCHES)
        b2, _ = _epoch_scalars(scalars, skip=n_lines)
        check(set(b2) == set(a2), f"run B's epoch-2 tags differ from A's: "
              f"{sorted(set(a2) ^ set(b2))}")

        def compare(x, y):
            d = {t: (abs(y[t] - v) / max(abs(v), 1e-30) if t in losses
                     else abs(y[t] - v)) for t, v in x.items()
                 if t not in ("epoch_seconds", "data_seconds")}
            return (d, max(d[t] for t in losses),
                    max(v for t, v in d.items()
                        if t.startswith(("val_", "best_val_", "test_"))))

        diffs, worst_loss, worst_metric = compare(a2, b2)
        over = {t: diffs[t] for t in losses
                if diffs[t] > RESUME_LOSS_RTOL[t]}
        log(f"run B (resume from E1): epoch-2 loss terms within "
            f"{worst_loss:.3e} relative of run A ("
            + ", ".join(f"{t} {diffs[t]:.2e}" for t in losses)
            + f"), val/test metrics within {worst_metric:.3e} absolute; "
            f"{sum(1 for v in diffs.values() if v == 0)}/{len(diffs)} "
            f"scalars bit-equal; launches {launches_b}")
        # the same resume with deterministic algorithms, in a child
        # process (cuBLAS takes its workspace setting at start-up)
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--resume-check",
             os.path.join(root, "deterministic")], capture_output=True,
            text=True, timeout=600,
            env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        check(child.returncode == 0, "the deterministic resume failed: "
              + child.stderr[-3000:])
        pair = json.loads([line for line in child.stdout.splitlines()
                           if line.startswith("RESUME_CHECK ")][-1][13:])
        tags = [t_ for t_ in pair["a"] if t_ not in ("epoch_seconds",
                                                     "data_seconds")]
        unequal = {t_: (pair["a"][t_], pair["b"].get(t_)) for t_ in tags
                   if pair["b"].get(t_) != pair["a"][t_]}
        log(f"deterministic algorithms (child process, "
            f"{time.perf_counter() - t:.1f} s): a resume from epoch 1 gives "
            f"{len(tags) - len(unequal)}/{len(tags)} epoch-2 scalars "
            f"bit-equal to the uninterrupted run's")
        check(len(tags) >= 80 and not unequal, f"deterministic resume "
              f"differs: {unequal}")
        check(launches_b == _expected(12, 0, 2 * 12), f"run B launches "
              f"{launches_b}")
        check(not over, f"run B's losses differ from run A's by more "
              f"than uninterrupted runs do ({RESUME_LOSS_RTOL}): {over}")
        check(worst_metric <= RESUME_METRIC_ATOL, f"run B's metrics differ "
              f"from run A's: {worst_metric}")
    finally:
        for k, fn in real.items():
            setattr(train_mod, k, fn)
        shutil.rmtree(root, ignore_errors=True)

    from geot_tpu_torch.core.config import EasyConfig

    workers_cfg = EasyConfig()
    workers_cfg.load(cfg_path, recursive=True)
    workers = int((workers_cfg.get("dataloader") or {}).get("num_workers",
                                                            4))
    val_first = [ms / n for _, (_, n, first), ms in timed["validate"]
                 if first]
    val_later = [ms / n for _, (_, n, first), ms in timed["validate"]
                 if not first]
    log(f"run A: {wall_a:.1f} s wall ({workers} loader threads); epochs "
        + ", ".join(f"{e}: {v['epoch_seconds']:.2f} s (data "
                    f"{v['data_seconds']:.2f} s)"
                    for e, v in sorted(epochs.items()) if e <= 2)
        + f"; host ms between steps after each epoch's first: mean "
        f"{sum(step_ms) / len(step_ms):.1f} (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}); peak memory {peak_mb:.0f} MiB")
    log("validate ms per scan (run, split, first pass on its loader?): "
        + "; ".join(f"{r} {tag}{' first' if first else ''} {ms / n:.2f}"
                    for r, (tag, n, first), ms in timed["validate"]))
    log(f"checkpoint {ckpt_bytes} bytes; save ms (latest, plus copies to "
        f"best and E<epoch>) "
        + "; ".join(f"{r} {what} {ms:.0f}" for r, what, ms in timed["save"])
        + "; load ms "
        + "; ".join(f"{r} {what} {ms:.0f}" for r, what, ms in timed["load"]))
    log(f"launches: run A {launches_a}")
    return {"launches": launches_a, "epochs": epochs, "step_ms": step_ms,
            "num_workers": workers,
            "validate_first_ms_per_scan": val_first,
            "validate_ms_per_scan": val_later, "ckpt_bytes": ckpt_bytes,
            "timed": timed, "peak_mb": peak_mb,
            "resume_loss_rel": worst_loss,
            "resume_metric_abs": worst_metric,
            "deterministic_resume_bit_equal": len(tags)}


# the serving topology of geot_tpu's ``serve --fast``
FAST = {"fast_pyramid": 1024, "fast_graph": True}
# launches per fast scan: the true-FPS prefix; the non-prefix rows of the 3
# FeaturePropagation levels and the 2 DGCNN cross-level searches (fast_graph
# drops the 2 fine-level self-searches); the full-resolution upsample
_PER_FAST_SCAN = _with_upsamples({"fps_cluster": 1, "knn_split": 5}, 1)
# bfloat16 on the card against the port's CPU bfloat16 forward of the same
# weights and input: bounds fixed from the CPU tests (tests/test_torch_fast.py
# ::test_bfloat16_forward_matches_jax) before the first card run (PERF.md
# §6): argmax agreement >= 0.98, and max |dlogit| at most 2 x the CPU's own
# bfloat16-vs-float32 max |dlogit|
BF16_AGREE = 0.98
BF16_ERR_RATIO = 2.0


def _launch_counts(**per):
    from geot_tpu_torch import ops

    return dict(dict.fromkeys(ops.LAUNCHES, 0), **per)


def phase_fast_serving(scans):
    """The serving topology (``fast_pyramid=1024``, ``fast_graph``) through
    the entry points: ``fps_stratified`` on the card against the CPU,
    ``predict_scan`` in float32 and bfloat16 (latency, idle share, peak
    memory, launches per scan), each forward against the port's CPU
    forward, votes, a two-member ensemble, ``predict_stream`` and one
    request to ``serve --fast`` in a child process."""
    import copy
    import queue
    import threading

    import numpy as np
    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan, pc_norm
    from geot_tpu_torch.data.transforms import build_transforms_from_cfg
    from geot_tpu_torch.engine.predict import (load_model, map_pred_to_fdi,
                                               predict_scan, predict_stream)

    log("phase 9: fast serving (fast_pyramid=1024, fast_graph)")
    small, _ = _synthetic_scan(32, 2000)
    sel = np.random.default_rng(0).choice(2000, 16000, replace=True)
    for label, x in (("a sampled scan", _scan_sample(31)[1]),
                     ("a 2,000-point scan sampled to 16,000",
                      pc_norm(small)[0][sel])):
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))[None]
        got = ops.fps_stratified(xt.cuda(), 16000, 1024).cpu()
        want = ops.fps_stratified(xt, 16000, 1024)
        check(torch.equal(got, want), f"fps_stratified on {label}: card "
              f"differs from CPU at {int((got != want).sum())} places")
        check(torch.equal(got.sort(dim=1).values[0],
                          torch.arange(16000, dtype=torch.int32)),
              f"fps_stratified on {label}: not a permutation")
        log(f"fps_stratified (1,16000)->16000, prefix 1024, on {label}: "
            f"card bit-equal to the CPU, a permutation")

    out = {"launches": _launch_counts()}

    def counted(want, what):
        got = dict(ops.LAUNCHES)
        check(got == want, f"{what}: launches {got}, expected {want}")
        for k in got:
            out["launches"][k] += got[k]

    models = {}
    per_scan = _launch_counts(**_PER_FAST_SCAN)
    for name, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        model = load_model(dict(FLAGSHIP_SEG_ARGS, **FAST, dtype=dtype),
                           seed=0, device="cuda")
        models[name] = model
        predict_scan(model, scans[0], jaw=0)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        lat = []
        for n in range(6):
            pts, jaw = scans[n % len(scans)], n % 2
            ops.reset_launches()
            t = time.perf_counter()
            pred, logits = predict_scan(model, pts, jaw=jaw)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
            counted(per_scan, f"fast {name} scan {n}")
            check(logits.shape == (16000, 17) and logits.dtype ==
                  torch.float32 and bool(torch.isfinite(logits).all()),
                  f"fast {name} scan {n}: logits not finite/shaped")
            check(pred.shape == (len(pts),) and pred.dtype == np.uint8
                  and _fdi_ok(map_pred_to_fdi(pred, jaw), jaw),
                  f"fast {name} scan {n}: bad labels")
        # above what was resident before: the models of earlier phases
        peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
        it = iter(scans * 3)
        wall, busy = _profile(f"fast {name} scan", lambda: predict_scan(
            model, next(it)), 3, top=8)
        out[name] = {"latency_ms": lat, "peak_mb": peak_mb,
                     "profiled_wall_ms_per_scan": wall / 3,
                     "device_busy_ms_per_scan": busy / 3,
                     "idle_share": 1 - busy / wall}
        log(f"fast {name}: 6 scans {', '.join(f'{x:.2f}' for x in lat)} "
            f"ms; peak memory "
            f"{peak_mb:.0f} MiB above the resident {resident / 2 ** 20:.0f} "
            f"MiB; launches per scan {per_scan}")

    # each forward on the card against the port's CPU forward, one input
    pos = torch.from_numpy(_scan_sample(21)[1])[None]
    cls = torch.zeros((1, 1), dtype=torch.long)
    fwd = {}
    with torch.no_grad():
        for name, model in models.items():
            t = time.perf_counter()
            cpu_model = copy.deepcopy(model).cpu()
            fwd[name] = (model({"pos": pos.cuda(), "x": None,
                                "cls": cls.cuda()})[0].cpu(),
                         cpu_model({"pos": pos, "x": None, "cls": cls})[0])
            log(f"fast {name} forward on the CPU: "
                f"{time.perf_counter() - t:.1f} s")
    (a32, b32), (abf, bbf) = fwd["float32"], fwd["bfloat16"]
    p99 = float(b32.abs().flatten().kthvalue(
        int(0.99 * b32.numel())).values)
    diff32 = float((a32 - b32).abs().max())
    agree32 = float((a32.argmax(-1) == b32.argmax(-1)).float().mean())
    diffbf = float((abf - bbf).abs().max())
    agreebf = float((abf.argmax(-1) == bbf.argmax(-1)).float().mean())
    cpu_bf_err = float((bbf - b32).abs().max())
    card_bf_err = float((abf - a32).abs().max())
    log(f"fast float32, card vs CPU: max |dlogit| {diff32:.3e} (logit p99 "
        f"{p99:.3f}: {diff32 / p99:.2e} of it), argmax agreement "
        f"{agree32:.6f}")
    log(f"fast bfloat16, card vs CPU: max |dlogit| {diffbf:.3e}, argmax "
        f"agreement {agreebf:.6f}; bfloat16-vs-float32 max |dlogit| CPU "
        f"{cpu_bf_err:.3e}, card {card_bf_err:.3e}; bound: agreement >= "
        f"{BF16_AGREE}, max |dlogit| <= {BF16_ERR_RATIO} x {cpu_bf_err:.3e}")
    check(diff32 <= 1e-3 * p99 and agree32 >= 0.999,
          "fast float32 forward: card disagrees with the CPU")
    check(agreebf >= BF16_AGREE and diffbf <= BF16_ERR_RATIO * cpu_bf_err,
          "fast bfloat16 forward: card disagrees with the CPU")
    out["card_vs_cpu"] = {"f32_max_abs": diff32, "f32_p99": p99,
                          "f32_agree": agree32, "bf16_max_abs": diffbf,
                          "bf16_agree": agreebf,
                          "bf16_vs_f32_cpu": cpu_bf_err,
                          "bf16_vs_f32_card": card_bf_err}

    # votes, a two-member ensemble and the stream, in float32
    model = models["float32"]
    vote_t = build_transforms_from_cfg(
        "vote", FLAGSHIP_SEMI_CFG["datatransforms"])
    ops.reset_launches()
    t = time.perf_counter()
    pred, _ = predict_scan(model, scans[0], jaw=0, num_votes=2,
                           vote_transform=vote_t)
    torch.cuda.synchronize()
    vote_ms = (time.perf_counter() - t) * 1e3
    counted(_with_upsamples(_launch_counts(fps_cluster=3, knn_split=3 * 5),
                            1), "2 votes")
    check(_fdi_ok(map_pred_to_fdi(pred, 0), 0), "2 votes: bad labels")
    members = (model, load_model(dict(FLAGSHIP_SEG_ARGS, **FAST), seed=1,
                                 device="cuda"))
    ops.reset_launches()
    t = time.perf_counter()
    pred, _ = predict_scan(members, scans[1], jaw=1)
    torch.cuda.synchronize()
    ens_ms = (time.perf_counter() - t) * 1e3
    counted(_with_upsamples(_launch_counts(fps_cluster=2, knn_split=2 * 5),
                            1), "ensemble")
    check(_fdi_ok(map_pred_to_fdi(pred, 1), 1), "ensemble: bad labels")
    items = [(f"scan{n}", scans[n % len(scans)], n % 2) for n in range(4)]
    rng = np.random.default_rng(0)
    expect = [predict_scan(members, p, jaw=j, seed=rng)[0]
              for _, p, j in items]
    list(predict_stream(members, iter(items), seed=0))       # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    streamed = list(predict_stream(members, iter(items), seed=0,
                                   inflight=2))
    stream_s = time.perf_counter() - t
    counted(_with_upsamples(_launch_counts(fps_cluster=4 * 2,
                                           knn_split=4 * 2 * 5), 4),
            "stream")
    check([x[0] for x in streamed] == [x[0] for x in items],
          "stream: order")
    for (name, _, got, _), exp in zip(streamed, expect):
        check(np.array_equal(got, exp), f"stream {name}: labels differ "
              f"from predict_scan at {int((got != exp).sum())} points")
    log(f"fast float32: 2 votes {vote_ms:.1f} ms a scan; a two-member "
        f"ensemble {ens_ms:.1f} ms a scan; predict_stream of 4 scans "
        f"through the ensemble {stream_s * 1e3:.1f} ms, labels equal to "
        f"predict_scan in the same draw order")
    out.update(vote_ms=vote_ms, ensemble_ms=ens_ms,
               stream_ms_per_scan=stream_s * 1e3 / 4)

    # one request to the serving CLI with --fast, in a child process
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "geot_tpu_torch.engine.serve", "--fast",
         "--port", "0"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def read():
        for x in proc.stdout:
            lines.put(x)
        lines.put("")                   # the child closed its output

    threading.Thread(target=read, daemon=True).start()
    try:
        line, seen = "", []
        while "serving on" not in line:
            try:
                line = lines.get(timeout=300)
            except queue.Empty:
                line = ""
            seen.append(line)
            check(bool(line), "serve --fast did not start: "
                  + "".join(seen[-20:]))
        base = line.split("serving on ")[1].split()[0]
        buf = io.BytesIO()
        np.save(buf, scans[2])
        req = urllib.request.Request(f"{base}/predict?jaw=lower",
                                     data=buf.getvalue(), method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            d = json.load(r)
        http_ms = (time.perf_counter() - t) * 1e3
        want, _ = predict_scan(model, scans[2], jaw=0)
        same = float(np.mean(np.asarray(d["labels"]) ==
                             np.asarray(map_pred_to_fdi(want, 0))))
        check(d["n_points"] == len(scans[2]) and _fdi_ok(d["labels"], 0)
              and same >= 0.999, f"serve --fast: bad answer (agreement "
              f"with predict_scan {same})")
        log(f"serve --fast (child process): POST /predict {http_ms:.1f} ms "
            f"round trip, labels agree with predict_scan {same:.6f}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    out["http_ms"] = http_ms
    return out


def phase_fast_trainer():
    """``_fast.yaml`` (a student in the serving topology, an exact teacher)
    through ``parse_and_run`` at full width: 1 epoch with validation and
    the test pass, then ``mode=test`` with 2 votes on its best checkpoint;
    ``fps_cluster`` launches counted by (batch, npoint)."""
    import collections
    import importlib
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path

    log("phase 10: fast trainer (parse_and_run, _fast.yaml, full width)")
    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm_fast.yaml")
    root = tempfile.mkdtemp(prefix="geot_fast_trainer_")
    shapes = collections.Counter()
    real = fps_mod.fps_cluster

    def counting(xyz, npoint, plan):
        shapes[f"({xyz.shape[0]},{xyz.shape[1]})->{npoint}"] += 1
        return real(xyz, npoint, plan)

    fps_mod.fps_cluster = counting
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ops.reset_launches()
        t = time.perf_counter()
        res = train_mod.parse_and_run(["--cfg", cfg_path, "epochs=1",
                                       "val_freq=1", f"root_dir={root}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(ops.LAUNCHES)
        shapes_a = dict(shapes)
        peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
        (run_dir,) = [os.path.join(root, "tooth_semi", d)
                      for d in os.listdir(os.path.join(root, "tooth_semi"))]
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            sc = {d["tag"]: d["value"] for d in map(json.loads, f)}
        with open(os.path.join(run_dir, "step_times.jsonl")) as f:
            step_ms = [json.loads(x)["dt"] * 1e3 for x in f]
        for split in ("val", "test"):
            bad = {k: v for k, v in res[split].items()
                   if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
            check(not bad, f"fast run: {split} metrics outside [0, 1]: "
                  f"{bad}")
        check(all(math.isfinite(sc[k]) for k in (
            "train_loss", "train_loss_l", "train_loss_u",
            "insT_threed_loss")), "fast run: a loss is not finite")
        # cm bootstrap 12 batches + 12 steps + val and test 12 batches
        # each: the student (B = 2 or 6, prefix 1024) everywhere, the exact
        # teacher (B = 2, 8192) in the steps; knn_split 5 a fast forward,
        # 7 an exact one; an upsample (the pruned route) an evaluated scan
        want = _with_upsamples(_launch_counts(
            fps_cluster=12 + 2 * 12 + 12 + 12,
            knn_split=12 * 5 + 12 * (5 + 7) + 2 * 12 * 5), 2 * 12 * 2)
        want_shapes = {"(2,16000)->1024": 36, "(6,16000)->1024": 12,
                       "(2,16000)->8192": 12}
        check(launches == want, f"fast run launches {launches}, expected "
              f"{want}")
        check(shapes_a == want_shapes, f"fast run fps_cluster shapes "
              f"{shapes_a}, expected {want_shapes}")

        shapes.clear()
        ops.reset_launches()
        best = ckpt_path(os.path.join(run_dir, "checkpoint"),
                         os.path.basename(run_dir), "best")
        t = time.perf_counter()
        res_t = train_mod.parse_and_run(
            ["--cfg", cfg_path, "mode=test", "num_votes=2",
             f"pretrained_path={best}", f"root_dir={root}"])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t
        launches_t = dict(ops.LAUNCHES)
        want = _with_upsamples(_launch_counts(fps_cluster=12 * 3,
                                              knn_split=12 * 3 * 5), 12 * 2)
        check(launches_t == want, f"mode=test with 2 votes: launches "
              f"{launches_t}, expected {want}")
        check(dict(shapes) == {"(2,16000)->1024": 36},
              f"mode=test fps_cluster shapes {dict(shapes)}")
        bad = {k: v for k, v in res_t["test"].items()
               if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
        check(not bad, f"mode=test with votes: metrics outside [0, 1]: "
              f"{bad}")
    finally:
        fps_mod.fps_cluster = real
        shutil.rmtree(root, ignore_errors=True)
    later = step_ms[1:]
    log(f"fast run: {wall:.1f} s wall; epoch {sc['epoch_seconds']:.2f} s "
        f"(data {sc['data_seconds']:.2f} s); host ms between steps mean "
        f"{sum(later) / len(later):.1f} (min {min(later):.1f}, max "
        f"{max(later):.1f}); peak memory {peak_mb:.0f} MiB above the "
        f"resident {resident / 2 ** 20:.0f} MiB; fps_cluster "
        f"launches by shape {shapes_a}; launches {launches}")
    log(f"mode=test with 2 votes: {test_s:.1f} s; whole miou "
        f"{res_t['test']['whole_miou']:.6f}; launches {launches_t}")
    total = {k: launches[k] + launches_t[k] for k in launches}
    return {"launches": total, "epoch_seconds": sc["epoch_seconds"],
            "data_seconds": sc["data_seconds"], "step_ms": step_ms,
            "fps_cluster_shapes": shapes_a, "peak_mb": peak_mb,
            "wall_s": wall, "test_votes_s": test_s}


# phase 11: the switches of the semi step on top of the flagship, as
# geot_tpu's all-flags runs set them (feat_k 16, the bank at trans_dim and
# 4096 rows); contrast_threshold is lowered where the bank must move, since
# no point of a random-init teacher clears the reference's 0.9
ALL_FLAGS = {"use_feat_loss": True, "feat_k": 16, "use_identity_loss": True,
             "use_contrastive": True, "pseudo_refine": True,
             "filter_outlier": True}
U_NAMES = ("Poly1FocalLoss_U_corr", "Poly1FocalLoss_U", "Weight_CELoss_U",
           "MSE_Loss_U", "Poly1FocalLoss_U_T", "Poly1FocalLoss_U_T_v1",
           "Poly1FocalLoss_U_Cur", "Poly1FocalLoss_U_top2")
# the loss terms of the all-flags step, card against CPU: phase 6's bound;
# the feature-space term against the whole loss (3.3e-5 in float32 at full
# width on an H100 at 700 W, PERF.md section 6)
BRANCH_LOSS_RTOL = 1e-4
BRANCH_FEAT_OF_LOSS = 1e-3
_LOSS_TERMS = ("loss", "sup_loss", "unsup_loss", "feat_loss",
               "identity_loss", "threed_loss", "contrast_loss")


def _state_tensors(state):
    """Every tensor of ``state.state_dict()`` by path, cloned; the
    generator's state apart (a skipped step still draws)."""
    import torch

    out = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif isinstance(v, torch.Tensor) and k != "generator":
                out[prefix + str(k)] = v.detach().clone()
    walk(state.state_dict(), "")
    return out


def _kernels_self_search(bound: Bound):
    """Kernel 2 at the self-search of a whole cloud, (2, 16000) x (2,
    16000), k = 2 (``Poly1FocalLoss_U_top2``): bit-equal to the plain
    version on two sampled scans and on 2,000 distinct points sampled to
    16,000; its split plan; kernel-only, wrapper and plain times."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops

    dev = torch.device("cuda")
    scan = torch.cat([torch.from_numpy(_scan_sample(s)[1])[None]
                      for s in (31, 32)]).to(dev).contiguous()
    rng = np.random.default_rng(5)
    dup = scan[:, torch.from_numpy(rng.integers(0, 2000, 16000)).to(dev)]
    dup = dup.contiguous()
    for label, xyz in (("scans", scan), ("2000 distinct of 16000", dup)):
        d, i = ops.knn_small_k(xyz, xyz, 2)
        d_r, i_r = ops.knn_small_k_ref(xyz, xyz, 2)
        torch.cuda.synchronize()
        check(torch.equal(i, i_r), f"self-search {label}: idx differ from "
              f"knn_small_k_ref at {int((i != i_r).sum())} places")
        check(torch.equal(d, d_r), f"self-search {label}: d2 not bit-equal")
        not_self = int((i[..., 0] != torch.arange(16000, device=dev)).sum())
        log(f"knn_split self-search {label} (2,16000)x(2,16000),k=2: idx "
            f"equal, d2 bit-equal to knn_small_k_ref; column 0 is not the "
            f"query at {not_self} of 32000 rows")
    check(not_self > 0, "the duplicate cloud has no tie at column 0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S, split_len = ops.knn_split_plan(2, 16000, 16000, sms)
    check(S > 1 and (S - 1) * split_len < 16000 <= S * split_len,
          f"split plan ({S}, {split_len}) at Q = N = 16000")
    t = {"ms": graph_ms(lambda: ops.knn_small_k(scan, scan, 2), 20),
         "wrapper_ms": cuda_ms(lambda: ops.knn_small_k(scan, scan, 2), 20),
         "plain_ms": cuda_ms(lambda: ops.knn_small_k_ref(scan, scan, 2), 2)}
    # 8 fp32 operations a pair distance and compare; inputs read once,
    # d2 and idx written once
    b_ms, b_by = bound(8.0 * 2 * 16000 * 16000,
                       2 * (2 * 16000 * 12 + 16000 * 2 * 8))
    log(f"knn_split self-search: {S} splits of {split_len}; kernel "
        f"{t['ms']:.4f} ms (wrapper {t['wrapper_ms']:.4f}), plain "
        f"{t['plain_ms']:.2f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(t, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
                splits=S, split_len=split_len)


def phase_branches(bound: Bound, cm):
    """Every branch of the semi step at full width (2 + 2 + 2 clouds of
    16,000 points): kernel 2 at the self-search shape; one step of the
    flagship, of all flags, of ``threed_anchors=4096`` and of each
    ``criterion_u`` name, timed and counted; the all-flags step on the card
    against the CPU (1 + 1 + 1 clouds, the same contrast draws); a step
    with a NaN skipped whole; the trainer on the flagship YAML with every
    switch of the slice and ``ema_eval``. Returns the kernels' records and
    the launches of the path."""
    import importlib
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data.build import (MODEL_KEYS, build_semi_loaders,
                                           semi_keys, semi_pairs, to_device)
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    log("phase 11: the semi-step branches at full width")
    rec = _kernels_self_search(bound)
    knn_mod = importlib.import_module("geot_tpu_torch.ops.knn")
    real_small_k = knn_mod.knn_small_k
    self_searches = []

    def counting(query, support, k):
        if query is support and k == 2:
            self_searches.append(tuple(query.shape))
        return real_small_k(query, support, k)

    dev = torch.device("cuda")
    base = dict(FLAGSHIP_SEMI_CFG, skip_nonfinite_updates=False)
    loaders = build_semi_loaders(base)
    for loader in loaders:
        loader.set_epoch(1)
    pairs = [(to_device(bl, MODEL_KEYS, dev), to_device(bu, semi_keys(bu),
                                                         dev))
             for bl, bu in semi_pairs(*loaders, limit=3)]
    # a per-point score for Poly1FocalLoss_U_Cur
    cur = torch.rand((2, 16000), generator=torch.Generator().manual_seed(9))
    for _, bu in pairs:
        bu["cur"] = cur.to(dev)
    state = SemiTrainState.create(base, seed=0, device=dev)
    state.cm = cm.to(dev)
    lr = 1e-3
    per_step = dict(dict.fromkeys(ops.LAUNCHES, 0), fps_cluster=2,
                    knn_split=14)
    variants = [("flagship", {}),
                ("all flags", dict(ALL_FLAGS, contrast_threshold=0.0)),
                ("threed_anchors=4096", {"threed_anchors": 4096})]
    variants += [(f"criterion_u {n}", {"criterion_u_args": {"NAME": n}})
                 for n in U_NAMES[1:]]
    times, launches = {}, dict.fromkeys(ops.LAUNCHES, 0)
    # every variant starts from the same state
    start = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                 and all(isinstance(t, torch.Tensor) for t in v.values())
                 else v) for k, v in state.state_dict().items()}
    knn_mod.knn_small_k = counting
    try:
        for label, extra in variants:
            state.load_state_dict(start)
            step = make_semi_step(dict(base, **extra))
            step(state, *pairs[0], lr, True)              # warm-up
            torch.cuda.synchronize()
            ms = []
            for bl, bu in pairs[1:]:
                ops.reset_launches()
                n_self = len(self_searches)
                t = time.perf_counter()
                m = step(state, bl, bu, lr, True)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                got = dict(ops.LAUNCHES)
                for k, v in got.items():
                    launches[k] += v
                top2 = label.endswith("top2")
                want = dict(per_step, knn_split=14 + top2)
                check(got == want, f"{label}: launches {got}, expected "
                      f"{want}")
                check(len(self_searches) - n_self == top2,
                      f"{label}: {len(self_searches) - n_self} self-searches")
                terms = {k: float(m[k]) for k in _LOSS_TERMS if k in m}
                check(all(math.isfinite(v) for v in terms.values()),
                      f"{label}: a loss is not finite: {terms}")
            times[label] = ms
            log(f"step {label}: {', '.join(f'{x:.1f}' for x in ms)} ms; "
                + ", ".join(f"{k} {v:.6f}" for k, v in terms.items()))
        rec["launches"] = sum(1 for s in self_searches if s == (2, 16000, 3))
        check(self_searches == [(2, 16000, 3)] * 3,
              f"self-searches {self_searches}, expected 3 at (2, 16000, 3)")
    finally:
        knn_mod.knn_small_k = real_small_k
    flag_ms = sum(times["flagship"]) / 2
    log("step ms against the flagship's " + f"{flag_ms:.1f}: " + "; ".join(
        f"{k} {sum(v) / 2:.1f} ({sum(v) / 2 / flag_ms:.2f}x)"
        for k, v in times.items()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    all_flags = make_semi_step(dict(base, **ALL_FLAGS,
                                    contrast_threshold=0.0))
    all_flags(state, *pairs[1], lr, True)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
    log(f"all-flags step peak memory {peak_mb:.0f} MiB above the resident "
        f"{resident / 2 ** 20:.0f} MiB")
    split = {}
    for label, extra in (("all-flags step", dict(ALL_FLAGS,
                                                 contrast_threshold=0.0)),
                         ("threed_anchors=4096 step",
                          {"threed_anchors": 4096}),
                         ("flagship step", {})):
        step = make_semi_step(dict(base, **extra))
        split[label] = _profile(label, lambda: step(state, *pairs[1], lr,
                                                    True), 1, top=12)

    # card against CPU: one all-flags step from the same seeded state,
    # 1 + 1 + 1 clouds, CMP_TRUNK, the same contrast draws; in float32,
    # and in float64 (the model and step in float64 around the float32
    # searches), as phase 6
    cfg1 = dict(base, batch_size_l=1, batch_size_u=1, **ALL_FLAGS)
    seg = dict(FLAGSHIP_SEG_ARGS, **CMP_TRUNK)
    bl1 = {k: v[:1].cpu() for k, v in pairs[0][0].items()}
    bu1 = {k: v[:1].cpu() for k, v in pairs[0][1].items() if k != "cur"}
    gen = torch.Generator().manual_seed(11)
    draws = (torch.rand((1, 16000), generator=gen),
             torch.randperm(1024, generator=gen))
    th = None
    compare = {}
    for dt in (torch.float32, torch.float64):
        res = {}
        for name in ("cuda", "cpu"):
            st = SemiTrainState.create(cfg1, seg_args=seg, seed=1,
                                       device=name)
            for mod in (st.model, st.teacher, st.t_predictor):
                mod.to(dt)
            st.ema_t, st.cm = st.ema_t.to(dt), cm.to(name, dt)
            st.contrast.queue = st.contrast.queue.to(dt)
            b_l, b_u = ({k: (v.to(name, dt) if v.is_floating_point()
                             else v.to(name)) for k, v in b.items()}
                        for b in (bl1, bu1))
            if th is None:
                # the gate passes the teacher's most confident 2-4 % (some
                # 500 of the cloud's 16,000 points: fewer than the 1,024
                # the loss samples, so its validity mask is live), set in
                # the widest gap between two confidences there, so the
                # CPU's rounding of them passes the same points
                with torch.no_grad():
                    conf = torch.sort(torch.softmax(st.teacher(
                        b_u, if_teacher=True)[0], -1).amax(-1).float()
                        .flatten())[0]
                lo, hi = int(0.96 * conf.numel()), int(0.98 * conf.numel())
                j = lo + int((conf[lo + 1:hi] - conf[lo:hi - 1]).argmax())
                th = float((conf[j] + conf[j + 1]) / 2)
            t = time.perf_counter()
            seen = dict(_SEARCH_STATS)
            with cpu_search_memo():
                m = make_semi_step(dict(cfg1, contrast_threshold=th))(
                    st, b_l, b_u, lr, True,
                    draws={"contrast": tuple(d.to(name) for d in draws)})
            terms = {k: float(m[k]) for k in _LOSS_TERMS}
            res[name] = (terms, int(st.contrast.ptr),
                         st.ema_t.double().cpu())
            log(f"all-flags {str(dt)[6:]} step, 1 + 1 + 1 clouds, on the "
                f"{name}: {time.perf_counter() - t:.1f} s; {terms}; bank "
                f"ptr {res[name][1]}; CPU searches " + ", ".join(
                    f"{k} {v - seen[k]}" for k, v in _SEARCH_STATS.items()))
        (lg, pg, eg), (lc, pc, ec) = res["cuda"], res["cpu"]
        # the feature-space term sums +1 and -1 weighted distances over
        # 17-channel neighbour sets, which follow the float32 rounding of
        # random init's near-equal softmax rows: it is held within
        # BRANCH_FEAT_OF_LOSS of the whole loss, and the rest of the loss
        # (loss - feat_loss) at the per-term bound
        for d in (lg, lc):
            d["loss_without_feat"] = d["loss"] - d["feat_loss"]
        rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc}
        feat = abs(lg["feat_loss"] - lc["feat_loss"]) / abs(lc["loss"])
        log(f"card vs CPU all-flags {str(dt)[6:]} step: loss terms "
            f"relative " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f"; feat_loss {feat:.2e} of the loss; ptr {pg} and {pc}; "
            f"ema_t max |d| {float((eg - ec).abs().max()):.2e}")
        held = {k: v for k, v in rel.items() if k not in ("loss",
                                                          "feat_loss")}
        check(all(v <= BRANCH_LOSS_RTOL for v in held.values())
              and feat <= BRANCH_FEAT_OF_LOSS,
              f"card vs CPU all-flags {dt} loss terms differ: {rel}; "
              f"feat_loss {feat} of the loss")
        check(pg == pc and 0 < pg < 1024, f"bank ptr {pg} on the card, "
              f"{pc} on the CPU: the same count of valid rows, some but "
              f"not all of the 1,024 sampled")
        # ema_t moves by 1e-3 x class_T, whose filter_outlier anchors
        # (a 0.97 quantile, then an argmax over near-equal softmax rows)
        # follow the forward's rounding: 1e-5, where phase 6 (no filter)
        # holds 1e-6
        check(float((eg - ec).abs().max()) <= 1e-5, "ema_t differs")
        compare[str(dt)[6:]] = dict(rel, feat_of_loss=feat,
                                    ema_t=float((eg - ec).abs().max()))

    # skip_nonfinite_updates: a NaN in the strong view skips the step whole
    guard = dict(base, skip_nonfinite_updates=True, ema_eval=0.99,
                 **ALL_FLAGS, contrast_threshold=0.0)
    gstate = SemiTrainState.create(guard, seed=2, device=dev)
    gstate.cm = cm.to(dev)
    gstep = make_semi_step(guard)
    m = gstep(gstate, *pairs[0], lr, True)
    check(float(m["skipped"]) == 0.0, "a clean step was skipped")
    before = _state_tensors(gstate)
    bl, bu = pairs[1]
    bad = dict(bu, pos_s=bu["pos_s"].clone())
    bad["pos_s"][1, 7, 0] = float("nan")
    m = gstep(gstate, bl, bad, lr, True)
    check(float(m["skipped"]) == 1.0 and float(m["loss"]) == 0.0,
          f"the NaN step: skipped {float(m['skipped'])}, loss "
          f"{float(m['loss'])}")
    after = _state_tensors(gstate)
    unequal = [k for k, v in before.items() if not torch.equal(v, after[k])]
    check(after.keys() == before.keys() and not unequal,
          f"a skipped step changed {unequal[:5]}")
    check(gstate.step == 2, "step counter")
    m = gstep(gstate, *pairs[2], lr, True)
    moved = _state_tensors(gstate)
    changed = {g: sum(1 for k in before if k.startswith(g)
                      and not torch.equal(before[k], moved[k]))
               for g in ("model/", "opt/", "t_opt/", "ema_params/",
                         "ema_t", "contrast/")}
    check(float(m["skipped"]) == 0.0 and all(changed.values()),
          f"the next clean step did not train: {changed}")
    log(f"skip_nonfinite_updates: the NaN step skipped, {len(before)} "
        f"state tensors bit-equal (weights, both AdamW states, BatchNorm "
        f"buffers, ema_t, the bank, the EMA shadow); the next step changed "
        f"{changed}")
    del gstate, before, after, moved

    # the trainer: the flagship YAML with every switch of the slice
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    root = tempfile.mkdtemp(prefix="geot_branches_")
    loads = []
    real_load = train_mod.load_variables

    def recording(path, prefer_ema="auto"):
        loads.append(prefer_ema)
        return real_load(path, prefer_ema)

    train_mod.load_variables = recording
    opts = [f"{k}={v}" for k, v in ALL_FLAGS.items()] + [
        "contrast_threshold=0.0", "threed_anchors=4096", "ema_eval=0.99",
        "skip_nonfinite_updates=True", "epochs=2", "val_freq=1",
        "test_freq=2", f"root_dir={root}"]
    try:
        ops.reset_launches()
        t = time.perf_counter()
        out = train_mod.parse_and_run(["--cfg", cfg_path, *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        trainer_launches = dict(ops.LAUNCHES)
        (run_dir,) = [os.path.join(root, "tooth_semi", d)
                      for d in os.listdir(os.path.join(root, "tooth_semi"))]
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            sc = {}
            for d in map(json.loads, f):
                sc.setdefault(d["tag"], []).append(d["value"])
    finally:
        train_mod.load_variables = real_load
        shutil.rmtree(root, ignore_errors=True)
    for split in ("val", "val_raw", "test"):
        bad = {k: v for k, v in out[split].items()
               if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
        check(not bad, f"trainer {split} metrics outside [0, 1]: {bad}")
    for tag in ("manifold_loss_feat", "insT_identity_loss",
                "insT_threed_loss", "contrast_loss", "val_raw_whole_miou"):
        check(tag in sc and all(map(math.isfinite, sc[tag])),
              f"trainer: scalar {tag} missing or not finite")
    check("skipped_steps" not in sc, "trainer skipped steps")
    won = bool(out["best"]["ema_selected"])
    check(loads == [won], f"the test pass loaded {loads}, the best tree was "
          f"{'ema' if won else 'raw'}")
    want = _expected(steps=24, cm_batches=12, eval_batches=5 * 12)
    check(trainer_launches == want, f"trainer launches {trainer_launches}, "
          f"expected {want} (24 steps, 12 cm batches, val + val_raw twice "
          f"and test)")
    for k, v in trainer_launches.items():
        launches[k] += v
    log(f"trainer (every switch, ema_eval=0.99): {wall:.1f} s; epochs "
        + ", ".join(f"{v:.2f} s" for v in sc["epoch_seconds"])
        + f"; val whole miou {out['val']['whole_miou']:.6f} (EMA), val_raw "
        f"{out['val_raw']['whole_miou']:.6f}; best tree "
        f"{'ema' if won else 'raw'} at epoch {out['best']['epoch']}, "
        f"reloaded for the test pass; launches {trainer_launches}")
    return {"self_search": rec, "launches": launches, "step_ms": times,
            "peak_mb": peak_mb, "profile": split, "card_vs_cpu": compare,
            "trainer_s": wall}


# phase 12: the supervised tooth zoo, cfgs/tooth_sup/*.yaml at full width
ZOO = ("pointnet2", "dgcnn", "pointmlp", "transformer")
# (fps_cluster, knn_split) launches of one forward, from the code: PointNet++
# and PointMLP one FPS per stage (4) and one 3-NN search per decoder level
# (4: supports of 62, 250, 1000 and 4000 points); DGCNN none (its k = 20
# searches take the tiled path, as in geot_tpu); PointTransformer_seg the
# flagship's 1 + 7. An eval batch of 2 scans adds one upsample per scan.
_ZOO_PER_FORWARD = {"pointnet2": (4, 4), "dgcnn": (0, 0), "pointmlp": (4, 4),
                    "transformer": (1, 7)}
# card vs CPU, one float64 step: loss relative and per-tensor gradient
# bounds. DGCNN's feature-space searches run in float32 on both sides
# (cuBLAS and the CPU's BLAS round the 64-channel |q|^2 - 2 q.s + |s|^2
# in different orders), and at random init near-tied neighbours swap:
# measured 5.5e-7 and 1.2e-3 on an H100 at 700 W (PERF.md section 6)
_ZOO_CMP_TOL = {"pointnet2": (1e-6, 1e-3), "dgcnn": (1e-5, 1e-2),
                "pointmlp": (1e-6, 1e-3), "transformer": (1e-6, 1e-3)}
# the configs' dropout and stochastic-depth switches, off for the
# card-vs-CPU step (PointMLP's fixed head dropout: its rate set to 0)
_ZOO_NO_DROPOUT = {
    "pointnet2": ["model.cls_args.dropout_ratio=0.0"],
    "dgcnn": ["model.cls_args.dropout_ratio=0.0"],
    "pointmlp": [],
    "transformer": ["model.segmentor_args.drop_path_rate=0.0",
                    "model.segmentor_args.head_dropout=0.0"]}


def _zoo_cfg(name, *opts):
    return _zoo_cfg_at(_zoo_path(name), *opts)


def _zoo_cfg_at(path, *opts):
    from geot_tpu_torch.core.config import EasyConfig

    cfg = EasyConfig()
    cfg.load(path, recursive=True)
    cfg.update(list(opts))
    return cfg


def _zoo_path(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfgs",
                        "tooth_sup", f"{name}.yaml")


def _zoo_chain(bound: Bound, xyz, npoints=(4000, 1000, 250, 62)):
    """An FPS chain of PointNet++ and PointMLP (the zoo's: 16000 -> 4000 ->
    1000 -> 250 -> 62) on the clouds ``xyz`` (B, N, 3): each call bit-equal
    to ``fps_ref`` and timed kernel-only (a CUDA graph) beside its plain
    version and bound. Returns the chain's record and its levels."""
    import importlib

    import torch

    from geot_tpu_torch import ops

    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    B = xyz.shape[0]
    C = fps_mod.card_cluster_size(xyz.device, B)
    levels = [xyz]
    chain = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "calls": {}}
    ops_, bytes_ = 0.0, 0.0
    for npoint in npoints:
        x = levels[-1]
        N = x.shape[1]
        plan = ops.fps_plan(N, C)
        got = ops.fps(x, npoint)
        ref = ops.fps_ref(x, npoint)
        torch.cuda.synchronize()
        label = f"({B},{N})->{npoint}"
        check(torch.equal(got, ref), f"fps {label}: indices differ from "
              f"fps_ref at {int((got != ref).sum())} places")
        ms = graph_ms(lambda: ops.fps(x, npoint), 10)
        plain = cuda_ms(lambda: ops.fps_ref(x, npoint), 1)
        b_ms, b_by = _fps_bound(bound, B, N, npoint)
        ops_ += 9.0 * B * (npoint - 1) * N
        bytes_ += B * N * 12 + B * npoint * 4
        chain["ms"] += ms
        chain["plain_ms"] += plain
        chain["bound_ms"] += b_ms
        chain["calls"][label] = {"ms": ms, "plain_ms": plain,
                                 "bound_ms": b_ms, "plan": list(plan)}
        log(f"fps {label}: plan {plan.route} C={plan.C} per_cta "
            f"{plan.per_cta} slots {plan.slots}; bit-equal to fps_ref; "
            f"kernel {ms:.4f} ms ({ms * 1e3 / (npoint - 1):.3f} us a step), "
            f"plain {plain:.1f} ms, bound {b_ms:.5f} ms ({b_by})")
        levels.append(ops.gather_points(x, got).contiguous())
    chain["bound_by"] = bound(ops_, bytes_)[1]
    chain["max_abs_err"] = 0.0

    return chain, levels


def _zoo_decoders(bound: Bound, levels, dup=None):
    """The decoders' four k = 3 searches between the chain's ``levels``
    (and, with ``dup``, one against a support with duplicated points):
    bit-equal to ``knn_small_k_ref``, timed kernel-only and as wrapper
    calls beside the plain version and the bound."""
    import torch

    from geot_tpu_torch import ops

    B = levels[0].shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    knn = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "calls": {}}
    ops_ = bytes_ = 0.0
    pairs = [(levels[3], levels[4]), (levels[2], levels[3]),
             (levels[1], levels[2]), (levels[0], levels[1])]
    for i, (q, s_) in enumerate(pairs + ([(levels[1], dup)] if dup
                                         is not None else [])):
        Q, N = q.shape[1], s_.shape[1]
        S, split_len = ops.knn_split_plan(B, Q, N, sms)
        d, idx = ops.knn_small_k(q, s_, 3)
        d_r, i_r = ops.knn_small_k_ref(q, s_, 3)
        torch.cuda.synchronize()
        label = f"({B},{Q})x({B},{N}) k=3"
        check(torch.equal(idx, i_r) and torch.equal(d, d_r),
              f"knn_split {label}: differs from knn_small_k_ref")
        if i == 4:
            log(f"knn_split duplicated supports {label}: {S} splits; "
                f"bit-equal")
            continue
        ms = graph_ms(lambda: ops.knn_small_k(q, s_, 3), 20)
        wrap = cuda_ms(lambda: ops.knn_small_k(q, s_, 3), 20)
        plain = cuda_ms(lambda: ops.knn_small_k_ref(q, s_, 3), 2)
        flops, nbytes = 8.0 * B * Q * N, B * ((Q + N) * 12 + Q * 3 * 8)
        b_ms, b_by = bound(flops, nbytes)
        ops_ += flops
        bytes_ += nbytes
        for k, v in (("ms", ms), ("wrapper_ms", wrap), ("plain_ms", plain),
                     ("bound_ms", b_ms)):
            knn[k] += v
        knn["calls"][label] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                               "splits": S}
        log(f"knn_split {label}: {S} splits of {split_len}; bit-equal; "
            f"kernel {ms:.4f} ms (wrapper {wrap:.4f}), plain {plain:.2f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
    knn["bound_by"] = bound(ops_, bytes_)[1]
    knn["max_abs_err"] = 0.0
    return knn


def _kernels_zoo(bound: Bound):
    """Kernels 1 and 2 at the zoo's shapes on 4 sampled scans: the FPS chain
    of PointNet++ and PointMLP (16000 -> 4000 -> 1000 -> 250 -> 62), the
    supervised transformer's 16000 -> 8192, the decoders' four k = 3
    searches (supports of 62 to 4000 points); each bit-equal to its plain
    version and timed kernel-only (a CUDA graph of the calls); and the
    named edge cases: a 62-point cloud on a 16-block cluster, a cloud with
    fewer distinct points than npoint, duplicated supports."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops

    dev = torch.device("cuda")
    xyz = torch.cat([torch.from_numpy(_scan_sample(s)[1])[None]
                     for s in (21, 22, 23, 24)]).to(dev).contiguous()
    B = xyz.shape[0]
    chain, levels = _zoo_chain(bound, xyz)

    got = ops.fps(xyz, 8192)
    ref = ops.fps_ref(xyz, 8192)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "fps (4,16000)->8192 differs from fps_ref")
    b_ms, b_by = _fps_bound(bound, B, 16000, 8192)
    t8192 = {"ms": graph_ms(lambda: ops.fps(xyz, 8192), 3),
             "plain_ms": cuda_ms(lambda: ops.fps_ref(xyz, 8192), 1),
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}
    log(f"fps ({B},16000)->8192 (the supervised transformer): bit-equal; "
        f"kernel {t8192['ms']:.4f} ms, plain {t8192['plain_ms']:.1f} ms, "
        f"bound {b_ms:.5f} ms ({b_by})")

    # a 62-point cloud on a 16-block cluster (4 points a block, most
    # threads empty), and a cloud of 40 distinct points sampled to 1000:
    # after 40 picks every min-distance is 0 and the first maximum,
    # index 0, repeats
    x62 = levels[-1]
    plan16 = ops.fps_plan(62, 16)
    got = ops.fps_cluster(x62, 16, plan16)
    check(torch.equal(got, ops.fps_ref(x62, 16)),
          f"fps_cluster 62 points on {plan16}: differs from fps_ref")
    sel = torch.from_numpy(np.random.default_rng(4).choice(40, 1000))
    few = xyz[:, :40][:, sel.to(dev)].contiguous()
    got = ops.fps(few, 250)
    ref = ops.fps_ref(few, 250)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "fps on 40 distinct points: differs")
    zeros = int((got[:, 1:] == 0).sum())
    check(zeros >= B * (250 - 40), f"fps on 40 distinct points repeats "
          f"index 0 only {zeros} times")
    log(f"fps edge cases: 62 points on {plan16.C} blocks of {plan16.per_cta} "
        f"and 40 distinct points sampled to 1000 -> 250 ({zeros} repeats "
        f"of index 0): bit-equal to fps_ref")

    knn = _zoo_decoders(bound, levels, dup=torch.cat(
        [levels[2], levels[2][:, :500]], dim=1).contiguous())
    log(f"the decoders' 4 searches: kernel {knn['ms']:.4f} ms (wrapper "
        f"{knn['wrapper_ms']:.4f}), bound {knn['bound_ms']:.5f} ms; the FPS "
        f"chain: kernel {chain['ms']:.3f} ms, bound {chain['bound_ms']:.5f} "
        f"ms")
    return {"fps_chain": chain, "fps_8192": t8192, "knn_decoder": knn}


def _zoo_card_vs_cpu(name, batch_np, lr, dev="cuda", opts=()):
    """One supervised step of the config from the same weights on one
    cloud, dropout off, in float64 around the float32 kernels, on the card
    and on the CPU: loss and per-tensor gradients (the first AdamW moment,
    relative to the tensor's largest) within ``_ZOO_CMP_TOL``. A tensor's
    scale is floored at 1e-6 of the largest gradient: a bias before a
    batch-statistics BatchNorm, PointMLP's ``affine_beta`` and, on one
    cloud, its global and jaw tokens feed only a per-batch constant that
    the next BatchNorm removes, so their gradient is 0 in exact
    arithmetic."""
    import torch

    from geot_tpu_torch.data.build import MODEL_KEYS, to_device
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step

    cfg = _zoo_cfg(name, *opts, *_ZOO_NO_DROPOUT[name])
    one = {k: v[:1] for k, v in batch_np.items()}
    res = {}
    for where, dev in (("card", dev), ("cpu", "cpu")):
        st = TrainState.create(cfg, cfg.model, seed=1, device=dev)
        st.model.double()
        if name == "pointmlp":
            st.model.dropout.rate = 0.0
        b = {k: (v.double() if v.is_floating_point() else v)
             for k, v in to_device(one, MODEL_KEYS, dev).items()}
        t = time.perf_counter()
        m = make_supervised_step(cfg)(st, b, lr)
        loss = float(m["loss"])
        secs = time.perf_counter() - t
        grads = {n: st.opt.state[p]["exp_avg"].detach().cpu()
                 for n, p in st.model.named_parameters()}
        res[where] = (loss, grads)
        log(f"{name}: one float64 step, 1 cloud, on the {where}: "
            f"{secs:.1f} s; loss {loss:.10f}")
    (lg, gg), (lc, gc) = res["card"], res["cpu"]
    rel = abs(lg - lc) / abs(lc)
    gmax = max(float(v.abs().max()) for v in gc.values())
    errs, vanish = {}, 0
    for k, ref in gc.items():
        scale = max(float(ref.abs().max()), 1e-6 * gmax)
        vanish += scale == 1e-6 * gmax
        errs[k] = float((gg[k] - ref).abs().max()) / scale
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:2]
    log(f"{name} card vs CPU float64 step: loss relative {rel:.2e}; "
        f"per-tensor gradient max |d| / max |g|: worst "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst)
        + f" ({len(errs)} tensors, {vanish} below 1e-6 of the largest "
        f"gradient)")
    loss_tol, grad_tol = _ZOO_CMP_TOL[name]
    check(rel <= loss_tol, f"{name} card vs CPU loss differs: {rel}")
    check(worst[0][1] <= grad_tol, f"{name} card vs CPU gradients: "
          f"{worst}")
    return {"loss_rel": rel, "grad_rel": worst[0][1]}


def _zoo_model(name, dev="cuda", opts=()):
    """One config at full width (``opts``: overrides, for a rehearsal at a
    small size): 1 warm and 2 timed supervised steps, their launches and
    peak memory, one profiled step, one step card vs CPU, then the trainer
    for 1 epoch and ``mode=test`` on its best checkpoint."""
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.data.build import (MODEL_KEYS,
                                           build_dataloader_from_cfg,
                                           to_device)
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    dev = torch.device(dev)
    cfg = _zoo_cfg(name, *opts)
    f, k = _ZOO_PER_FORWARD[name]
    bs = int(cfg.batch_size_l)
    t = time.perf_counter()
    state = TrainState.create(cfg, cfg.model, seed=0, device=dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    loader = build_dataloader_from_cfg(bs, cfg.dataset_l, cfg.datatransforms,
                                       split="train", seed=int(cfg.seed))
    loader.set_epoch(1)
    it = iter(loader)
    batches = [next(it) for _ in range(3)]
    log(f"{name}: {cfg.model.NAME}, {n_params} parameters, batch {bs} x "
        f"{cfg.num_points} points; built in {time.perf_counter() - t:.1f} s")
    step = make_supervised_step(cfg)
    lr = build_scheduler_from_cfg(cfg)(1)
    want = _launch_counts(fps_cluster=f, knn_split=k)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step_ms = []
    for n, b in enumerate(batches):
        b = to_device(b, MODEL_KEYS, dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        m = step(state, b, lr)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        got = dict(ops.LAUNCHES)
        check(math.isfinite(float(m["loss"])), f"{name} step {n}: loss "
              f"{float(m['loss'])}")
        check(got == want, f"{name} step {n}: launches {got}, expected "
              f"{want}")
        for key, v in got.items():
            launches[key] += v
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
    log(f"{name}: steps {', '.join(f'{x:.1f}' for x in step_ms)} ms (the "
        f"first warm); loss {float(m['loss']):.6f}; launches a step {want}; "
        f"peak memory {peak_mb:.0f} MiB above the resident "
        f"{resident / 2 ** 20:.0f} MiB")
    b0 = to_device(batches[0], MODEL_KEYS, dev)
    wall, busy = _profile(f"{name} supervised step",
                          lambda: step(state, b0, lr), 1, top=10)
    del state
    torch.cuda.empty_cache()
    compare = _zoo_card_vs_cpu(name, batches[0], lr, dev, opts)

    root = tempfile.mkdtemp(prefix=f"geot_zoo_{name}_")
    try:
        steps = len(loader)
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = train_mod.parse_and_run(["--cfg", _zoo_path(name), "epochs=1",
                                       "val_freq=1", "test_freq=1",
                                       "save_freq=1", f"root_dir={root}",
                                       f"device={dev.type}", *opts])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        run_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        got = dict(ops.LAUNCHES)
        # 12 val + 12 test batches of 2 scans, an upsample a scan
        want_run = _with_upsamples(_launch_counts(
            fps_cluster=steps * f + 24 * f, knn_split=steps * k + 24 * k),
            24 * 2)
        check(got == want_run, f"{name} trainer launches {got}, expected "
              f"{want_run}")
        (run_dir,) = [os.path.join(root, "tooth_sup", d)
                      for d in os.listdir(os.path.join(root, "tooth_sup"))]
        with open(os.path.join(run_dir, "scalars.jsonl")) as fh:
            sc = {d["tag"]: d["value"] for d in map(json.loads, fh)}
        with open(os.path.join(run_dir, "step_times.jsonl")) as fh:
            between = [json.loads(x)["dt"] * 1e3 for x in fh][1:]
        check(math.isfinite(sc["train_loss"]), f"{name}: train_loss")
        for split in ("val", "test"):
            bad = {k_: v for k_, v in res[split].items()
                   if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
            check(not bad, f"{name} trainer: {split} metrics {bad}")
        ck = os.path.join(run_dir, "checkpoint")
        tags = ("latest", "best", "E1")
        for tag in tags:
            check(os.path.exists(ckpt_path(ck, os.path.basename(run_dir),
                                           tag)), f"{name}: no {tag}")
        best = ckpt_path(ck, os.path.basename(run_dir), "best")
        ops.reset_launches()
        t = time.perf_counter()
        res_t = train_mod.parse_and_run(["--cfg", _zoo_path(name),
                                         "mode=test",
                                         f"pretrained_path={best}",
                                         f"root_dir={root}",
                                         f"device={dev.type}", *opts])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t
        got_t = dict(ops.LAUNCHES)
        want_t = _with_upsamples(_launch_counts(fps_cluster=12 * f,
                                                knn_split=12 * k), 12 * 2)
        check(got_t == want_t, f"{name} mode=test launches {got_t}, "
              f"expected {want_t}")
        check(abs(res_t["test"]["whole_miou"] - res["test"]["whole_miou"])
              <= 1e-6, f"{name}: mode=test whole_miou "
              f"{res_t['test']['whole_miou']} vs the run's "
              f"{res['test']['whole_miou']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"{name} trainer: {run_s:.1f} s for 1 epoch of {steps} steps, "
        f"validation and the test pass; epoch {sc['epoch_seconds']:.2f} s "
        f"(data {sc['data_seconds']:.2f} s); host ms between steps "
        f"{', '.join(f'{x:.1f}' for x in between)}; peak memory "
        f"{run_peak:.0f} MiB; val whole miou {res['val']['whole_miou']:.6f}; "
        f"mode=test {test_s:.1f} s, whole miou "
        f"{res_t['test']['whole_miou']:.6f}; launches {got} + {got_t}")
    for key in launches:
        launches[key] += got[key] + got_t[key]
    return {"params": n_params, "step_ms": step_ms, "peak_mb": peak_mb,
            "profile_wall_ms": wall, "profile_busy_ms": busy,
            "compare": compare, "epoch_seconds": sc["epoch_seconds"],
            "data_seconds": sc["data_seconds"], "run_s": run_s,
            "run_peak_mb": run_peak, "test_s": test_s,
            "launches": launches}


def phase_zoo(bound: Bound):
    """Phase 12: the kernels at the zoo's shapes, then each config of
    ``cfgs/tooth_sup`` through its steps and the trainer."""
    import collections
    import importlib

    from geot_tpu_torch import ops

    log("phase 12: the supervised tooth zoo (cfgs/tooth_sup) at full width")
    recs = _kernels_zoo(bound)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    models = {}
    # the kernels' launches by shape, through counting wrappers
    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    knn_mod = importlib.import_module("geot_tpu_torch.ops.knn")
    real_fps, real_knn = fps_mod.fps_cluster, knn_mod.knn_small_k
    shapes = collections.Counter()

    def fps_counted(xyz, npoint, plan):
        shapes[("fps", xyz.shape[1], npoint)] += 1
        return real_fps(xyz, npoint, plan)

    def knn_counted(q, s_, k):
        shapes[("knn", q.shape[1], s_.shape[1], k)] += 1
        return real_knn(q, s_, k)

    fps_mod.fps_cluster, knn_mod.knn_small_k = fps_counted, knn_counted
    try:
        for name in ZOO:
            models[name] = _zoo_model(name)
            for key, v in models[name]["launches"].items():
                launches[key] += v
    finally:
        fps_mod.fps_cluster, knn_mod.knn_small_k = real_fps, real_knn
    chain = ((16000, 4000), (4000, 1000), (1000, 250), (250, 62))
    by_shape = {
        "fps_chain": {f"{n}->{m}": shapes[("fps", n, m)] for n, m in chain},
        "knn_decoder": {f"{m}x{n}": shapes[("knn", m, n, 3)]
                        for m, n in ((250, 62), (1000, 250), (4000, 1000),
                                     (16000, 4000))}}
    log(f"zoo launches at the chain and decoder shapes: {by_shape}")
    log("zoo step ms (2 timed): " + "; ".join(
        f"{n} {m['step_ms'][1]:.1f} / {m['step_ms'][2]:.1f}"
        for n, m in models.items()) + "; epoch s: " + "; ".join(
        f"{n} {m['epoch_seconds']:.2f}" for n, m in models.items()))
    return {"kernels": recs, "models": models, "launches": launches,
            "launches_by_shape": by_shape}


# phase 13: file input and the serving CLI. A Teeth3DS tree of 6 scans of
# 40,000 points and one of 150,000 (an intraoral mesh larger than the
# synthetic scan): the first 4 are the labelled train split, the next 2 the
# unlabelled one, and scans 0, 5 and 6 the test list (val and test)
_FILES_SCANS = [(f"P{i:03d}", i % 2, 300 + i, 40000) for i in range(6)] + \
    [("P006", 0, 306, 150000)]
_FILES_SPLITS = {"semi_l_train_0.2.txt": (0, 1, 2, 3),
                 "semi_u_train_0.2.txt": (4, 5), "testing.txt": (0, 5, 6)}
# card against CPU for a served zoo scan, the sampled logits: phase 4's
# float32 bound, and for DGCNN, whose k = 20 searches on 64-channel
# features swap near-tied neighbours between cuBLAS and the CPU's BLAS,
# argmax agreement >= 0.99 with at most 1 % of the sampled points past
# phase 4's bound (stated in PERF.md section 6 before the first card run)
_SERVE_ZOO_AGREE = {"pointnet2": 0.999, "dgcnn": 0.99, "pointmlp": 0.999,
                    "transformer": 0.999}
_SERVE_ZOO_OVER = {"pointnet2": 0.0, "dgcnn": 0.01, "pointmlp": 0.0,
                   "transformer": 0.0}
# (fps_cluster, knn_split) launches of one served zoo scan, the forward's
# (phase 12's table); the full-resolution upsample adds UPSAMPLE
_SERVE_ZOO_PER_SCAN = {"pointnet2": (4, 4), "dgcnn": (0, 0),
                       "pointmlp": (4, 4), "transformer": (1, 7)}


def _write_obj(path, pts):
    """OBJ text of ``pts``: one ``v`` line each (shortest repr, exact in
    float32), a normal after each vertex and one face."""
    with open(path, "w") as f:
        f.write("# synthetic tooth scan\n")
        f.writelines(f"v {x!r} {y!r} {z!r}\nvn 0 0 1\n"
                     for x, y, z in pts.astype("float64").tolist())
        f.write("f 1 2 3\n")


def _write_teeth3ds(root, scans, splits):
    """A Teeth3DS tree: ``<id>_<lower|upper>.obj``, JSON labels in FDI
    codes of the jaw, ``data.json`` (absolute paths) and the split lists.
    ``scans``: (mesh_id, jaw, points, class ids)."""
    from geot_tpu_torch.engine.predict import map_pred_to_fdi

    index = {"scans": {}, "gt": {}}
    lines = []
    for mesh_id, jaw, pts, labels in scans:
        line = f"{mesh_id}_{'lower' if jaw == 0 else 'upper'}"
        index["scans"][line] = os.path.join(root, line + ".obj")
        index["gt"][line] = os.path.join(root, line + ".json")
        _write_obj(index["scans"][line], pts)
        with open(index["gt"][line], "w") as f:
            json.dump({"id_patient": mesh_id,
                       "labels": map_pred_to_fdi(labels, jaw)}, f)
        lines.append(line)
    with open(os.path.join(root, "data.json"), "w") as f:
        json.dump(index, f)
    for name, which in splits.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines[i] for i in which) + "\n")
    return [os.path.join(root, line + ".obj") for line in lines]


def _kernels_upsample(bound: Bound, pts):
    """Kernel 2 at the full-resolution upsample of a 150,000-point scan:
    its points padded to 19 x 8,192 rows against the 16,000 sampled, k = 3,
    bit-equal to the plain version, timed kernel-only, as wrapper calls and
    plain; and the search's route (the pruned kernel, phase 3 times it)
    bit-equal and timed as wrapper calls."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.data.tooth_semi import pc_norm
    from geot_tpu_torch.engine.eval import BUCKET, pad_to_bucket

    norm, _, _ = pc_norm(pts)
    sel = np.random.default_rng(0).choice(len(norm), 16000, replace=False)
    q = torch.from_numpy(pad_to_bucket(norm, BUCKET))[None].cuda()
    s_ = torch.from_numpy(np.ascontiguousarray(norm[sel]))[None].cuda()
    Q, N = q.shape[1], s_.shape[1]
    d, idx = ops.knn_split(q, s_, 3)
    d_r, i_r = ops.knn_small_k_ref(q, s_, 3)
    d_p, i_p = ops.knn_small_k(q, s_, 3)              # the route: pruned
    torch.cuda.synchronize()
    label = f"(1,{Q})x(1,{N}) k=3"
    check(torch.equal(idx, i_r) and torch.equal(d, d_r),
          f"knn_split {label}: differs from knn_small_k_ref")
    check(torch.equal(i_p, i_r) and torch.equal(d_p, d_r),
          f"knn_small_k ({ops.knn_route(Q, N)}) {label}: differs from "
          f"knn_small_k_ref")
    b_ms, b_by = bound(8.0 * Q * N, (Q + N) * 12 + Q * 3 * 8)
    rec = {"ms": graph_ms(lambda: ops.knn_split(q, s_, 3), 5),
           "wrapper_ms": cuda_ms(lambda: ops.knn_split(q, s_, 3), 5),
           "plain_ms": cuda_ms(lambda: ops.knn_small_k_ref(q, s_, 3), 1),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
           "splits": ops.knn_split_plan(1, Q, N, torch.cuda
                                        .get_device_properties(0)
                                        .multi_processor_count)[0]}
    rec["route_wrapper_ms"] = cuda_ms(lambda: ops.knn_small_k(q, s_, 3), 5)
    log(f"knn_split upsample {label}: {rec['splits']} splits; bit-equal; "
        f"kernel {rec['ms']:.4f} ms (wrapper {rec['wrapper_ms']:.4f}), "
        f"plain {rec['plain_ms']:.2f} ms, bound {b_ms:.5f} ms ({b_by}); the "
        f"route ({ops.knn_route(Q, N)}, plan included) "
        f"{rec['route_wrapper_ms']:.4f} ms, bit-equal")
    return rec


def _serve_zoo(name, pts):
    """A ``cfgs/tooth_sup`` model at its published width with seeded
    weights serving a 40,000-point scan on the card: a warm scan, 5 timed
    ones with their launches, and the sampled logits against the same
    model's CPU forward on the same sample (phase 4's comparison)."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.data.tooth_semi import pc_norm
    from geot_tpu_torch.engine.predict import load_model, predict_scan
    from geot_tpu_torch.engine.steps import _logits_of

    model_cfg = dict(_zoo_cfg(name).model)
    card = load_model(model_cfg=model_cfg, seed=0, device="cuda")
    predict_scan(card, pts, jaw=1)
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    ms = []
    for _ in range(5):
        t = time.perf_counter()
        _, logits = predict_scan(card, pts, jaw=1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    per_scan = {k: (ops.LAUNCHES[k] - before[k]) / 5 for k in before}
    want = dict.fromkeys(per_scan, 0)
    want["fps_cluster"], want["knn_split"] = _SERVE_ZOO_PER_SCAN[name]
    want = _with_upsamples(want, 1)
    check(per_scan == want, f"{name}: launches a scan {per_scan}, "
          f"expected {want}")
    # the same model's CPU forward on the sample predict_scan drew (seed 0)
    cpu = load_model(model_cfg=model_cfg, seed=0, device="cpu")
    norm, _, _ = pc_norm(pts)
    sel = np.random.default_rng(0).choice(len(norm), 16000,
                                          replace=len(norm) < 16000)
    pos = torch.from_numpy(np.ascontiguousarray(norm[sel]))[None]
    t = time.perf_counter()
    with torch.no_grad():
        b = _logits_of(cpu({"pos": pos, "x": pos, "cls": torch.ones(
            (1, 1), dtype=torch.long)}))[0]
    cpu_s = time.perf_counter() - t
    a = logits.cpu()
    scale = max(1.0, float(b.abs().max()))
    over = float(((a - b).abs().amax(-1) > 1e-3 * scale).float().mean())
    diff = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"serving {name} (B = 1, 40000 points): scan ms median "
        f"{sorted(ms)[2]:.2f} ({', '.join(f'{x:.1f}' for x in ms)}); "
        f"launches a scan {per_scan['fps_cluster']:g} fps_cluster + "
        f"{per_scan['knn_split']:g} knn_split; card vs CPU: max |dlogit| "
        f"{diff:.3e} (logit scale {scale:.2f}), sampled points past "
        f"1e-3 x scale {over * 16000:.0f} of 16000, argmax agreement "
        f"{agree:.6f} (CPU forward {cpu_s:.1f} s)")
    check(logits.shape == (16000, 17) and bool(torch.isfinite(a).all()),
          f"{name}: logits {tuple(logits.shape)} not finite")
    check(agree >= _SERVE_ZOO_AGREE[name] and over <= _SERVE_ZOO_OVER[name],
          f"{name}: card disagrees with the CPU (agreement {agree}, points "
          f"past the bound {over})")
    return {"scan_ms": ms, "launches_per_scan": per_scan, "max_dlogit": diff,
            "logit_scale": scale, "points_past_bound": over * 16000,
            "argmax_agreement": agree}


def _http_zoo(pts):
    """``serve`` of ``cfgs/tooth_sup/pointnet2.yaml`` on the card: an OBJ
    text body, a request whose prediction raises (400), and ``/metrics``
    counting both."""
    import numpy as np

    from geot_tpu_torch.engine.predict import map_pred_to_fdi, predict_scan
    from geot_tpu_torch.engine.serve import serve

    httpd = serve(model_cfg=dict(_zoo_cfg("pointnet2").model), port=0,
                  device="cuda", seed=0, warmup=True)
    service = httpd.service
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = "".join(f"v {x!r} {y!r} {z!r}\n" for x, y, z in
                   pts.astype("float64").tolist()).encode()
    try:
        t = time.perf_counter()
        req = urllib.request.Request(f"{base}/predict?jaw=upper", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            d = json.load(r)
        dt = (time.perf_counter() - t) * 1e3
        want, _ = predict_scan(service.model, pts, jaw=1)
        same = float(np.mean(np.asarray(d["labels"]) ==
                             np.asarray(map_pred_to_fdi(want, 1))))
        check(d["n_points"] == len(pts) and _fdi_ok(d["labels"], 1)
              and same >= 0.999, f"OBJ body: bad answer (agreement with "
              f"predict_scan {same})")

        def boom(points, jaw):
            raise RuntimeError("prediction failed")

        service.predict = boom
        req = urllib.request.Request(f"{base}/predict", data=body,
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=120)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        check(code == 400, f"a failing prediction answered {code}")
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode().splitlines()
        for line in ('geot_requests_total{outcome="ok"} 1',
                     'geot_requests_total{outcome="error"} 1',
                     "geot_request_seconds_count 1",
                     "geot_scans_served_total 1"):
            check(line in metrics, f"/metrics lacks {line!r}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"http (pointnet2): OBJ body of {len(pts)} points {dt:.1f} ms round "
        f"trip, labels agree with predict_scan {same:.6f}; a failing "
        f"prediction 400; /metrics counts 1 ok, 1 error, 1 scan served")
    return {"obj_round_trip_ms": dt, "agreement": same}


def phase_files(bound: Bound):
    """Phase 13: Teeth3DS on disk through the trainer, the predict CLI on
    OBJ scans (a directory, votes, the fast topology, a PLY), a reference
    ``.pth``, the supervised zoo served at B = 1 and over HTTP, and kernels
    1 and 2 at this phase's new shapes."""
    import collections
    import importlib
    import shutil
    import tempfile

    import numpy as np
    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data.io import _read_ply_xyz, load_obj_vertices
    from geot_tpu_torch.data.tooth_semi import (TeethSegSemiLDataset,
                                                TeethSegSemiUDataset,
                                                _synthetic_scan)
    from geot_tpu_torch.data.transforms import build_transforms_from_cfg
    from geot_tpu_torch.engine import predict
    from geot_tpu_torch.engine import train as train_mod

    log("phase 13: file input and the serving CLI")
    t_phase = time.perf_counter()
    flagship = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    scans = [(m, jaw, *_synthetic_scan(seed, n))
             for m, jaw, seed, n in _FILES_SCANS]
    # kernels 1 and 2 at the new shapes: a served zoo scan's FPS chain and
    # decoder searches (B = 1), the upsample of the 150,000-point scan
    xyz = torch.from_numpy(_scan_sample(25)[1])[None].cuda().contiguous()
    chain, levels = _zoo_chain(bound, xyz)
    recs = {"fps_chain": chain, "knn_decoder": _zoo_decoders(bound, levels),
            "knn_upsample": _kernels_upsample(bound, scans[6][2])}
    log(f"B = 1: the FPS chain kernel {chain['ms']:.3f} ms (bound "
        f"{chain['bound_ms']:.5f}), the decoders' 4 searches "
        f"{recs['knn_decoder']['ms']:.4f} ms (bound "
        f"{recs['knn_decoder']['bound_ms']:.5f})")

    # the main paths of this phase, launches counted by shape
    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    knn_mod = importlib.import_module("geot_tpu_torch.ops.knn")
    real_fps, real_knn = fps_mod.fps_cluster, knn_mod.knn_small_k
    shapes = collections.Counter()

    def fps_counted(x, npoint, plan):
        shapes[("fps", x.shape[0], x.shape[1], npoint)] += 1
        return real_fps(x, npoint, plan)

    def knn_counted(q, s_, k):
        shapes[("knn", q.shape[0], q.shape[1], s_.shape[1], k)] += 1
        return real_knn(q, s_, k)

    root = tempfile.mkdtemp(prefix="geot_files_")
    out = {}
    fps_mod.fps_cluster, knn_mod.knn_small_k = fps_counted, knn_counted
    ops.reset_launches()
    try:
        tree = os.path.join(root, "teeth3ds")
        os.makedirs(tree)
        t = time.perf_counter()
        objs = _write_teeth3ds(tree, scans, _FILES_SPLITS)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        big = load_obj_vertices(objs[6])
        parse_ms = (time.perf_counter() - t) * 1e3
        check(np.array_equal(big, scans[6][2]), "the 150,000-vertex OBJ "
              "does not parse to the points written")
        log(f"Teeth3DS tree of {len(objs)} scans written in {write_s:.2f} "
            f"s; OBJ parse of the 150,000-vertex scan {parse_ms:.1f} ms "
            f"({os.path.getsize(objs[6])} bytes)")
        # the on-disk items against the arrays they were written from
        tf = FLAGSHIP_SEMI_CFG["datatransforms"]
        test = TeethSegSemiLDataset(tree, 16000, "test",
                                    transform=build_transforms_from_cfg(
                                        "test", tf))
        check(not test.synthetic and len(test) == 3, "test split")
        for i, j in enumerate(_FILES_SPLITS["testing.txt"]):
            item, (m, jaw, pts, labels) = test[i], scans[j]
            check(item["patient"] == m and int(item["cls"][0]) == jaw
                  and np.array_equal(item["points"], pts)
                  and np.array_equal(item["labels"], labels)
                  and item["pos"].shape == (16000, 3),
                  f"test item {i} differs from scan {m}")
        u = TeethSegSemiUDataset(tree, 16000, "train",
                                 transform_w=build_transforms_from_cfg(
                                     "train_w", tf),
                                 transform_s=build_transforms_from_cfg(
                                     "train_s", tf))[0]
        check(u["pos_s"].shape == (16000, 3)
              and bool(np.isfinite(u["pos_s"]).all()), "unlabelled item")

        # the trainer for 1 epoch on the tree: 2 steps, the cm bootstrap
        # over 2 batches, val and test over 3 scans each (2 batches)
        ops.reset_launches()
        t = time.perf_counter()
        res = train_mod.parse_and_run([
            "--cfg", flagship, f"root_dir={os.path.join(root, 'runs')}",
            f"dataset_l.common.data_root={tree}",
            f"dataset_u.common.data_root={tree}", "epochs=1", "val_freq=1",
            "test_freq=1", "save_freq=100"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = dict(ops.LAUNCHES)
        want = dict.fromkeys(launches, 0)
        want["fps_cluster"] = 2 * 2 + 2 + 4
        want["knn_split"] = 2 * 14 + 2 * 7 + 4 * 7
        want = _with_upsamples(want, 6)             # one a scan evaluated
        check(launches == want, f"trainer launches {launches}, expected "
              f"{want}")
        run_dir = os.path.join(root, "runs", "tooth_semi",
                               os.listdir(os.path.join(root, "runs",
                                                       "tooth_semi"))[0])
        sc = {}
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            for line in f:
                d = json.loads(line)
                sc[d["tag"]] = d["value"]
        losses = {k: sc[k] for k in ("train_loss", "train_loss_l",
                                     "train_loss_u", "insT_threed_loss")}
        check(all(math.isfinite(v) for v in losses.values()),
              f"trainer losses not finite: {losses}")
        for split in ("val", "test"):
            check(all(math.isfinite(v) and 0 <= v <= 1
                      for v in res[split].values()), f"{split} metrics")
        log(f"trainer on the tree (1 epoch, 2 steps, val and test over 3 "
            f"scans): {train_s:.1f} s; losses {losses}; val whole miou "
            f"{res['val']['whole_miou']:.4f}; launches {launches}")
        out["trainer"] = {"seconds": train_s, "losses": losses,
                          "launches": launches}

        # the predict CLI on the card: the tree's OBJ scans as a directory
        ops.reset_launches()
        t = time.perf_counter()
        n = predict.main(["--cfg", flagship, "--input", tree, "--output",
                          os.path.join(root, "labels")])
        dir_s = time.perf_counter() - t
        check(n == len(objs) and dict(ops.LAUNCHES) == _with_upsamples(
            dict(dict.fromkeys(ops.LAUNCHES, 0), fps_cluster=n,
                 knn_split=7 * n), n),
            f"directory: {n} scans, launches {dict(ops.LAUNCHES)}")
        for m, jaw, pts, _ in scans:
            stem = f"{m}_{'lower' if jaw == 0 else 'upper'}"
            with open(os.path.join(root, "labels", stem + ".json")) as f:
                d = json.load(f)
            check(d["n_points"] == len(pts) and d["jaw"] == ("lower" if jaw
                                                             == 0 else
                                                             "upper")
                  and _fdi_ok(d["labels"], jaw), f"directory: {stem}")
        log(f"predict CLI, a directory of {n} OBJ scans: {dir_s:.2f} s, "
            f"{n / dir_s:.2f} scans/s end-to-end (model build and OBJ "
            f"parsing included)")
        # one scan with 2 votes, one in the fast topology with a PLY
        single = {}
        for tag, extra, per in (
                ("votes", ["--votes", "2"], _with_upsamples(
                    {"fps_cluster": 3, "knn_split": 3 * 7}, 1)),
                ("fast", ["--fast", "--ply", os.path.join(root, "p.ply")],
                 _PER_FAST_SCAN)):
            ops.reset_launches()
            path = os.path.join(root, f"{tag}.json")
            labels = predict.main(["--cfg", flagship, "--input", objs[0],
                                   "--output", path, *extra])
            grew = dict(ops.LAUNCHES)
            check(grew == dict(dict.fromkeys(grew, 0), **per),
                  f"--{tag}: launches {grew}")
            with open(path) as f:
                d = json.load(f)
            check(d["labels"] == labels and len(labels) == 40000
                  and _fdi_ok(labels, 0) and d["jaw"] == "lower",
                  f"--{tag}: labels")
            single[tag] = d["seconds"]
        back = _read_ply_xyz(os.path.join(root, "p.ply"))
        err = float(np.abs(back - scans[0][2]).max())
        # 5 decimals in the text: half a unit of the 5th, plus float32
        # rounding of coordinates below 2
        check(back.shape == (40000, 3) and err <= 5e-6 + 2.4e-7,
              f"--ply reads back {back.shape}, max |d| {err}")
        log(f"predict CLI, one scan: --votes 2 {single['votes']:.2f} s, "
            f"--fast {single['fast']:.2f} s; --ply read back within "
            f"{err:.2e}")
        out["cli"] = {"dir_seconds": dir_s, "scans": n,
                      "scans_per_s": n / dir_s, "single_s": single,
                      "obj_parse_ms_150000": parse_ms, "ply_err": err}

        # a reference .pth against the same weights as a state_dict file
        sd = {k: v.cpu() for k, v in predict.load_model(
            FLAGSHIP_SEG_ARGS, seed=0, device="cuda").state_dict().items()}
        pth = os.path.join(root, "reference.pth")
        torch.save({"model": {"module." + k: v for k, v in sd.items()},
                    "epoch": 3}, pth)
        plain = os.path.join(root, "weights.pt")
        torch.save(sd, plain)
        got = [predict.predict_scan(predict.load_model(ckpt=p,
                                                       device="cuda"),
                                    scans[1][2], jaw=1) for p in (pth, plain)]
        check(np.array_equal(got[0][0], got[1][0])
              and torch.equal(got[0][1], got[1][1]),
              "a reference .pth predicts other labels than its state_dict")
        log("reference .pth {'model': {'module.' + k: v}, 'epoch': 3}: "
            "labels and logits bit-equal to the same weights as a "
            "state_dict file")

        # the supervised zoo served at B = 1, then over HTTP
        zoo_scan = _synthetic_scan(31, 40000)[0]
        out["zoo"] = {name: _serve_zoo(name, zoo_scan) for name in ZOO}
        out["http"] = _http_zoo(zoo_scan)
    finally:
        fps_mod.fps_cluster, knn_mod.knn_small_k = real_fps, real_knn
        shutil.rmtree(root, ignore_errors=True)
    chain_shapes = [(1, 16000, 4000), (1, 4000, 1000), (1, 1000, 250),
                    (1, 250, 62)]
    dec_shapes = [(1, 250, 62), (1, 1000, 250), (1, 4000, 1000),
                  (1, 16000, 4000)]
    by_shape = {
        "fps_chain": {f"{n}->{m}": shapes[("fps", b, n, m)]
                      for b, n, m in chain_shapes},
        "knn_decoder": {f"{q}x{n}": shapes[("knn", b, q, n, 3)]
                        for b, q, n in dec_shapes},
        "knn_upsample": shapes[("knn", 1, 155648, 16000, 3)]}
    launches = {"fps_cluster": sum(v for k, v in shapes.items()
                                   if k[0] == "fps"),
                "knn_split": sum(v for k, v in shapes.items()
                                 if k[0] == "knn" and ops.knn_route(
                                     k[2], k[3]) == "knn_split")}
    launches = _with_upsamples(launches, sum(
        v for k, v in shapes.items() if k[0] == "knn"
        and ops.knn_route(k[2], k[3]) == "knn_small_k_pruned"))
    check(by_shape["knn_upsample"] == 3, f"the 150,000-point upsample ran "
          f"{by_shape['knn_upsample']} times, expected 3 (val, test, CLI)")
    log(f"phase 13 launches by shape: {by_shape}; in all {launches}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"kernels": recs, "launches": launches,
            "launches_by_shape": by_shape, **out}


# phase 14: the native OBJ parser, the exported forward and data
# parallelism. Bounds stated in PERF.md section 6 before the first card run:
# the artifact's logits against the eager forward's, of the logit scale
ARTIFACT_LOGIT_TOL = 1e-5
# two ranks against one process on the same global batches (2 + 2 + 2, one
# step an epoch, 2 epochs). The first step's loss terms, relative (the
# forward alone):
DP_FIRST_LOSS_RTOL = 1e-4
# AdamW's first moments after step 1 (0.1 x the summed gradient), tensor by
# tensor, of the tensor's largest entry floored at DP_ZERO_GRAD_FLOOR of the
# largest entry of all (a bias followed by BatchNorm has a gradient that is
# rounding), as tests/test_torch_dist.py holds them on the CPU:
DP_MOMENT_TOL = 0.5
DP_ZERO_GRAD_FLOOR = 1e-3
# the second step's loss terms, relative, and the root mean square of the
# weights' difference after step 2, in learning rates:
DP_SECOND_LOSS_RTOL = 1e-3
DP_WEIGHT_RMS_LR = 0.3
# Each of these three bounds lies between the sound run's reading and that
# of a control run (_DP_CONTROL) whose ranks send rank 0's gradient to every
# rank in place of the sum: the ranks stay equal, so only the comparison
# with one process can see it. On an H100 80GB HBM3 at 700 W (PERF.md
# section 6, PR 12) the sound run read 6.783e-2, 7.155e-5 and 0.0357 lr,
# the control 1.353e4, 7.247e-2 and 1.7398 lr. An error of scale alone (the
# average in place of the sum) changes no update here: the gradient is
# clipped to a global norm of 1 (grad_norm_clip) and AdamW drops its scale.
# the Teeth3DS tree of phase 14: 2 labelled scans (a step of 2 + 2 + 2 an
# epoch), 2 unlabelled, and one test scan (val and test)
_DP_SPLITS = {"semi_l_train_0.2.txt": (0, 1),
              "semi_u_train_0.2.txt": (4, 5), "testing.txt": (0,)}
# dropout and stochastic depth off, as tests/dist_worker.py runs geot_tpu's
# multi-process check
_DP_NO_DROPOUT = ("model.segmentor_args.drop_path_rate=0.0",
                  "model_t.segmentor_args.drop_path_rate=0.0",
                  "model.segmentor_args.head_dropout=0.0",
                  "model_t.segmentor_args.head_dropout=0.0")
# one rank of the control run: the trainer with rank 0's part of each
# gradient, times the world, in place of the ranks' sum: the T-predictor's,
# whose parts are equal, stay sound
_DP_CONTROL = r"""
import sys
from geot_tpu_torch.engine import train
from geot_tpu_torch.parallel import dist

def rank0_only(params):
    for p in params:
        dist.broadcast_(p.grad)
        p.grad.mul_(dist.world())


dist.sum_gradients = rank0_only
train.parse_and_run(sys.argv[1:])
dist.shutdown()
"""

# loads the artifacts in a fresh process that imports torch and the ops
_ARTIFACT_CHILD = r"""
import json, sys, time
import torch
import geot_tpu_torch.ops as ops
paths, inputs, out = sys.argv[1].split(","), sys.argv[2], sys.argv[3]
x = torch.load(inputs)
res = {}
for name, path in zip(("exact", "fast"), paths):
    t = time.perf_counter()
    fwd = torch.export.load(path).module()
    load_s = time.perf_counter() - t
    with torch.no_grad():
        fwd(x["pos"], x["cls"])
        ops.reset_launches()
        logits = fwd(x["pos"], x["cls"])
        torch.cuda.synchronize()
    res[name] = {"launches": dict(ops.LAUNCHES), "load_s": load_s}
    torch.save(logits.cpu(), f"{out}.{name}.pt")
res["models_imported"] = sorted(
    m for m in sys.modules if m.startswith("geot_tpu_torch.models")
    or m.split(".")[0] in ("jax", "flax", "geot_tpu", "yaml"))
print(json.dumps(res))
"""


def _steplosses(text):
    """The ``steploss`` lines of a trainer's log: [(loss, sup, unsup)] and
    the steps' milliseconds."""
    losses, ms = [], []
    for line in text.splitlines():
        if " steploss " in line:
            f = line.split(" steploss ")[1].split()
            losses.append((float(f[1]), float(f[3]), float(f[5])))
            ms.append(float(f[7]))
    return losses, ms


def _step_launches(text):
    """The ``launches step`` lines of a trainer's log: each step's kernel
    launches on every rank, [[{kernel: n} per rank] per step]."""
    return [json.loads(line.split(" launches step ")[1].split(" ", 1)[1])
            for line in text.splitlines() if " launches step " in line]


def _rank_env(here):
    """The rendezvous of two ranks on this node, as ``engine.launch`` sets
    it."""
    from geot_tpu_torch.engine.launch import find_free_port

    return dict(os.environ, MASTER_ADDR="localhost",
                MASTER_PORT=str(find_free_port()), WORLD_SIZE="2",
                LOCAL_WORLD_SIZE="2", GEOT_LOG_STEP_LOSS="1",
                PYTHONPATH=here)


def _start_control(common, here, root):
    """Start the two-rank trainer with ``_DP_CONTROL``'s reduction; returns
    its run directory and its ranks (process, output file)."""
    env, run = _rank_env(here), os.path.join(root, "rank0_only")
    os.makedirs(run)
    procs = []
    for r in range(2):
        out = open(os.path.join(run, f"rank{r}.out"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _DP_CONTROL, *common, f"run_dir={run}",
             "run_name=rank0_only"], cwd=here,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=out,
            stderr=subprocess.STDOUT), out))
    return run, procs


def _wait_control(run, procs, timeout=600):
    """Wait for the control's ranks (all killed once one fails or the time
    is up); returns its run directory and rank 0's output."""
    deadline = time.perf_counter() + timeout
    try:
        while (any(p.poll() is None for p, _ in procs)
               and not any(p.poll() for p, _ in procs)
               and time.perf_counter() < deadline):
            time.sleep(0.5)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    failed = [out.name for p, out in procs if p.returncode != 0]
    check(not failed, "the control run failed or timed out: " + "; ".join(
        f"{name}:\n{open(name).read()[-2000:]}" for name in failed))
    return run, open(procs[0][1].name).read()


def _dp_state(run, tag):
    """The state a run's checkpoint ``tag`` (``E1`` after step 1,
    ``latest`` after step 2) holds."""
    ck = os.path.join(run, "checkpoint")
    name = [f for f in os.listdir(ck) if f.endswith(f"_ckpt_{tag}.pth")][0]
    import torch

    return torch.load(os.path.join(ck, name), map_location="cpu",
                      weights_only=True)["state"]


def _moment_err(got, ref):
    """AdamW's first moments of ``got`` against ``ref`` (optimizer
    state_dicts): the worst tensor's max |difference| over its scale
    (its largest entry, floored at ``DP_ZERO_GRAD_FLOOR`` of the largest
    entry of all), and that tensor's index."""
    ref, got = ref["state"], got["state"]
    gmax = max(float(v["exp_avg"].abs().max()) for v in ref.values())
    worst = (-1.0, -1)
    for i, v in ref.items():
        scale = max(float(v["exp_avg"].abs().max()), DP_ZERO_GRAD_FLOOR * gmax)
        err = float((got[i]["exp_avg"] - v["exp_avg"]).abs().max()) / scale
        worst = max(worst, (err, i))
    return worst


def _weight_rms_lr(got, ref, lr):
    """The root mean square and the largest |difference| of the weights of
    two model state_dicts (BatchNorm statistics left out), in ``lr``."""
    keys = [k for k, v in ref.items()
            if v.is_floating_point() and "running" not in k]
    sq = sum(float((got[k] - ref[k]).double().square().sum()) for k in keys)
    n = sum(ref[k].numel() for k in keys)
    top = max(float((got[k] - ref[k]).abs().max()) for k in keys)
    return math.sqrt(sq / n) / lr, top / lr


def _rel_terms(a, b):
    """The largest relative difference of two steps' loss terms."""
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))


def _ops_rows(bound: Bound):
    """Kernels 1 and 2 through the custom ops ``geot::fps`` and
    ``geot::knn_small_k``: bit-equal to their plain versions, and the op's
    time beside the direct wrapper's, at the exact scan's shapes."""
    import importlib

    import torch

    from geot_tpu_torch import ops

    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    knn_mod = importlib.import_module("geot_tpu_torch.ops.knn")
    pts, pos0, center, scale = _scan_sample(11)
    pos = torch.from_numpy(pos0)[None].cuda()
    got = torch.ops.geot.fps(pos, 8192)
    ref = ops.fps_ref(pos, 8192)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "geot::fps differs from fps_ref")
    t_op = cuda_ms(lambda: torch.ops.geot.fps(pos, 8192), 5)
    t_direct = cuda_ms(lambda: fps_mod.fps_direct(pos, 8192), 5)
    t_plain = cuda_ms(lambda: ops.fps_ref(pos, 8192), 1)
    b_ms, b_by = _fps_bound(bound, 1, 16000, 8192)
    fps_row = {"ms": t_op, "direct_ms": t_direct, "plain_ms": t_plain,
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}
    searches, _, _ = _scan_searches(pts, pos, center, scale)
    knn_row = {"ms": 0.0, "direct_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "max_abs_err": 0.0,
               "routes": dict.fromkeys(("knn_split", "knn_small_k_pruned"),
                                       0)}
    flops = nbytes = 0.0
    for label, q, s_, k in searches:
        d, i = torch.ops.geot.knn_small_k(q, s_, k)
        d_r, i_r = ops.knn_small_k_ref(q, s_, k)
        torch.cuda.synchronize()
        check(torch.equal(i, i_r) and torch.equal(d, d_r),
              f"geot::knn_small_k {label}: not bit-equal to the plain "
              f"version")
        knn_row["ms"] += cuda_ms(
            lambda: torch.ops.geot.knn_small_k(q, s_, k), 20)
        knn_row["direct_ms"] += cuda_ms(
            lambda: knn_mod.knn_small_k_direct(q, s_, k), 20)
        knn_row["plain_ms"] += cuda_ms(
            lambda: ops.knn_small_k_ref(q, s_, k), 2)
        B, Q, N = q.shape[0], q.shape[1], s_.shape[1]
        knn_row["routes"][ops.knn_route(Q, N)] += 1
        f, nb = 8.0 * B * Q * N, B * ((Q + N) * 12 + Q * k * 8)
        knn_row["bound_ms"] += bound(f, nb)[0]
        flops += f
        nbytes += nb
    knn_row["bound_by"] = bound(flops, nbytes)[1]
    log(f"through the custom ops: geot::fps (1,16000)->8192 {t_op:.3f} ms "
        f"(direct wrapper {t_direct:.3f}, plain {t_plain:.1f}, bound "
        f"{b_ms:.4f}); geot::knn_small_k, the scan's 8 searches "
        f"{knn_row['ms']:.4f} ms (direct wrapper {knn_row['direct_ms']:.4f}, "
        f"plain {knn_row['plain_ms']:.2f}, bound {knn_row['bound_ms']:.4f}; "
        f"routes {knn_row['routes']}); both bit-equal to their plain "
        f"versions")
    return fps_row, knn_row


def phase_export_dp(bound: Bound):
    """Phase 14: the native OBJ parser, the flagship exported and served
    as an artifact, ``predict_stream`` over several devices, and two ranks
    training the flagship through ``engine.launch``."""
    import contextlib
    import io as iolib
    import shutil
    import tempfile

    import numpy as np
    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data import io as tio
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan
    from geot_tpu_torch.engine import export as texport
    from geot_tpu_torch.engine import predict
    from geot_tpu_torch.engine import serve as tserve
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.ops import _build

    log("phase 14: native parse, export, and data parallel")
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    flagship = os.path.join(here, "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    root = tempfile.mkdtemp(prefix="geot_dp_")
    out = {}
    control_procs = []
    # launches on this phase's main paths: the scans through the artifacts
    # and eagerly, the artifact served over HTTP, the streams and the
    # one-process trainer (the ranks' launches are in their processes)
    total = dict.fromkeys(ops.LAUNCHES, 0)

    def counted():
        for k, v in ops.LAUNCHES.items():
            total[k] += v
        ops.reset_launches()

    try:
        # the native parser against the numpy parser, 150,000 vertices
        pts150 = _synthetic_scan(306, 150000)[0]
        big = os.path.join(root, "big.obj")
        _write_obj(big, pts150)
        t = time.perf_counter()
        built = _build.build_native()
        build_s = time.perf_counter() - t
        native_ms = []
        for _ in range(3):
            t = time.perf_counter()
            got = tio.load_obj_vertices(big)
            native_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        plain = tio.load_obj_vertices_numpy(big)
        numpy_ms = (time.perf_counter() - t) * 1e3
        check(np.array_equal(got, plain) and np.array_equal(got, pts150),
              "the native parse differs from the numpy parse")
        log(f"OBJ of 150,000 vertices ({os.path.getsize(big)} bytes): "
            f"native {', '.join(f'{x:.1f}' for x in native_ms)} ms, numpy "
            f"{numpy_ms:.1f} ms, bit-equal (g++ build {build_s:.2f} s, "
            f"{built['seconds']:.2f} s compiling)")
        out["parse"] = {"native_ms": native_ms, "numpy_ms": numpy_ms,
                        "build_s": build_s}

        ops_rows = _ops_rows(bound)

        # the Teeth3DS tree and the trainer's arguments of the two-rank
        # runs below (the control starts beside the artifact's process)
        tree = os.path.join(root, "teeth3ds")
        os.makedirs(tree)
        _write_teeth3ds(tree, [(f"P{i:03d}", i % 2,
                                *_synthetic_scan(500 + i, 40000))
                               for i in range(6)], _DP_SPLITS)
        common = ["--cfg", flagship, f"dataset_l.common.data_root={tree}",
                  f"dataset_u.common.data_root={tree}", "epochs=2",
                  "seed=3", "val_freq=1", "test_freq=2", "save_freq=1",
                  *_DP_NO_DROPOUT]

        # the flagship exported by the CLI, exact and fast, from a
        # state_dict file of seeded weights
        model = predict.load_model(FLAGSHIP_SEG_ARGS, seed=0, device="cuda")
        weights = os.path.join(root, "w.pt")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   weights)
        fast_over = ["model.segmentor_args.fast_pyramid=1024",
                     "model.segmentor_args.fast_graph=True"]
        arts, export_s = {}, {}
        for name, over in (("exact", []), ("fast", fast_over)):
            arts[name] = os.path.join(root, f"{name}.pt2")
            t = time.perf_counter()
            texport.export_cli(["--cfg", flagship, "--ckpt", weights,
                                "--out", arts[name], *over])
            export_s[name] = time.perf_counter() - t
        fast_model = predict.load_model(
            dict(FLAGSHIP_SEG_ARGS, fast_pyramid=1024, fast_graph=True),
            ckpt=weights, device="cuda")
        pos = torch.from_numpy(_scan_sample(21)[1])[None].cuda()
        cls = torch.ones((1, 1), dtype=torch.long, device="cuda")
        eager, eager_launch = {}, {}
        for name, m in (("exact", model), ("fast", fast_model)):
            with torch.no_grad():
                ops.reset_launches()
                eager[name] = m({"pos": pos, "x": pos, "cls": cls})[0].cpu()
                eager_launch[name] = dict(ops.LAUNCHES)
        torch.save({"pos": pos, "cls": cls}, os.path.join(root, "in.pt"))
        # the wrong-reduction control of the two-rank check, beside the
        # artifact's process (whose load times it shares the host with)
        t_control = time.perf_counter()
        control = _start_control(common, here, root)
        control_procs = control[1]
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", _ARTIFACT_CHILD,
             ",".join((arts["exact"], arts["fast"])),
             os.path.join(root, "in.pt"), os.path.join(root, "logits")],
            capture_output=True, text=True, timeout=300, cwd=root,
            env=dict(os.environ, PYTHONPATH=here))
        child_s = time.perf_counter() - t
        control = _wait_control(*control)
        control_s = time.perf_counter() - t_control
        check(child.returncode == 0, f"artifact child failed:\n"
              f"{child.stderr[-3000:]}")
        res = json.loads(child.stdout.strip().splitlines()[-1])
        check(res["models_imported"] == [], f"the artifact's process "
              f"imported {res['models_imported']}")
        art = {}
        for name in ("exact", "fast"):
            a = torch.load(os.path.join(root, f"logits.{name}.pt"))
            e = eager[name]
            scale = float(e.abs().max())
            diff = float((a - e).abs().max())
            check(diff <= ARTIFACT_LOGIT_TOL * scale
                  and torch.equal(a.argmax(-1), e.argmax(-1)),
                  f"{name} artifact: max |dlogit| {diff} of {scale}")
            check(res[name]["launches"] == eager_launch[name],
                  f"{name} artifact launches {res[name]['launches']}, the "
                  f"eager forward's {eager_launch[name]}")
            art[name] = {"export_s": export_s[name], "max_abs_dlogit": diff,
                         "logit_scale": scale,
                         "launches_per_forward": res[name]["launches"],
                         "load_s": res[name]["load_s"],
                         "bytes": os.path.getsize(arts[name])}
            log(f"{name} artifact: exported in {export_s[name]:.1f} s "
                f"({art[name]['bytes']} bytes); loaded in a fresh process "
                f"(no model module imported) in {res[name]['load_s']:.2f} "
                f"s; max |dlogit| {diff:.3e} of {scale:.2f}, argmax equal; "
                f"launches a forward {res[name]['launches']} (eager's "
                f"too)")
        log(f"artifact child process: {child_s:.1f} s; the control run "
            f"beside it {control_s:.1f} s")

        # a served scan through the artifact against the eager one, in
        # turns; launches a scan
        scan = _synthetic_scan(21, 40000)[0]
        scan_ms = {}
        for name, m in (("exact", model), ("fast", fast_model)):
            am = tserve._artifact_model(arts[name])[0]
            per = {"eager": [], "artifact": []}
            for rep in range(4):
                for kind, mm in (("eager", m), ("artifact", am)):
                    ops.reset_launches()
                    t = time.perf_counter()
                    pred, _ = predict.predict_scan(mm, scan, jaw=1)
                    torch.cuda.synchronize()
                    per[kind].append((time.perf_counter() - t) * 1e3)
                    want = (_with_upsamples(
                        {"fps_cluster": 1, "knn_split": 7}, 1)
                        if name == "exact" else dict(_PER_FAST_SCAN))
                    grew = {k: v for k, v in ops.LAUNCHES.items() if v}
                    check(grew == want, f"{name} {kind} scan launches "
                          f"{grew}, expected {want}")
                    counted()
            scan_ms[name] = {k: v[1:] for k, v in per.items()}
            log(f"{name} scan of 40,000 points (1 fps_cluster + "
                f"{want['knn_split']} knn_split + the upsample's "
                f"{UPSAMPLE} each way): eager "
                f"{', '.join(f'{x:.1f}' for x in per['eager'][1:])} ms; "
                f"through the artifact "
                f"{', '.join(f'{x:.1f}' for x in per['artifact'][1:])} ms")
        out["artifact"] = art
        out["scan_ms"] = scan_ms
        # where a fast scan's time goes, eagerly and through the artifact:
        # the card's busy share and the host's operator calls
        prof = {}
        for kind, mm in (("eager", fast_model), ("artifact", am)):
            wall, busy = _profile(f"fast {kind} scan", lambda: (
                predict.predict_scan(mm, scan, jaw=1)), 3, top=5)
            prof[kind] = {"wall_ms_per_scan": wall / 3,
                          "device_busy_ms_per_scan": busy / 3,
                          "idle_share": 1 - busy / wall}
        # and unprofiled, 4 scans back to back each way (the turns above
        # alternate the two)
        for kind, mm in (("eager", fast_model), ("artifact", am)):
            ms = []
            for _ in range(4):
                t = time.perf_counter()
                predict.predict_scan(mm, scan, jaw=1)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            prof[kind]["back_to_back_ms"] = ms[1:]
        b2b = {k: ", ".join(f"{x:.1f}" for x in v["back_to_back_ms"])
               for k, v in prof.items()}
        log(f"fast scan back to back: eager {b2b['eager']} ms; through the "
            f"artifact {b2b['artifact']} ms")
        out["fast_profile"] = prof

        # serve --artifact over HTTP: an OBJ body's labels
        want_pred, _ = predict.predict_scan(model, scan, jaw=1)
        ops.reset_launches()
        httpd = tserve.serve(port=0, artifact=arts["exact"])
        try:
            body = "".join(f"v {x!r} {y!r} {z!r}\n" for x, y, z in
                           scan.astype("float64").tolist()).encode()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            req = urllib.request.Request(f"{url}/predict?jaw=upper",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got = json.loads(r.read())
            check(got["labels"] == predict.map_pred_to_fdi(want_pred, 1),
                  "serve --artifact: labels differ from predict_scan's")
            log(f"serve --artifact: an OBJ body of 40,000 points answered "
                f"in {got['seconds']:.4f} s, labels equal to predict_scan's "
                f"eager labels")
        finally:
            httpd.shutdown()
            httpd.server_close()
        counted()

        # predict_stream over every card (cuda:0 twice on a one-card
        # machine) against one device
        n_cards = torch.cuda.device_count()
        devs = ([f"cuda:{i}" for i in range(n_cards)] if n_cards > 1
                else ["cuda:0", "cuda:0"])
        items = [(f"s{i}", _synthetic_scan(400 + i, 40000)[0], i % 2)
                 for i in range(4)]
        ops.reset_launches()
        one = list(predict.predict_stream(model, items))
        t = time.perf_counter()
        many = list(predict.predict_stream(model, items, devices=devs))
        stream_s = time.perf_counter() - t
        counted()
        check([x[0] for x in many] == [x[0] for x in items]
              and all(np.array_equal(a[2], b[2]) for a, b in zip(one, many)),
              f"predict_stream over {devs}: labels differ from one "
              f"device's")
        log(f"predict_stream over {devs}: 4 scans in {stream_s:.2f} s, "
            f"labels equal to one device's, in input order")

        # two ranks through engine.launch against one process, the
        # flagship at full width on the Teeth3DS tree: 2 epochs of one step
        # (checkpoints E1 after step 1, latest after step 2); the control
        # ran beside the artifact's process
        del model, fast_model, am
        torch.cuda.empty_cache()
        backend = "nccl" if n_cards >= 2 else "gloo"
        run2 = os.path.join(root, "two")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "geot_tpu_torch.engine.launch",
             "--nprocs", "2", "--run-dir", run2, "--", *common],
            cwd=here, env=_rank_env(here), timeout=600, capture_output=True,
            text=True)
        two_s = time.perf_counter() - t
        check(proc.returncode == 0, f"two-rank launch failed:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}")
        log0 = open(os.path.join(run2, "rank0.log")).read()
        check(f"rank 0 of 2 ({backend})" in log0,
              f"the ranks did not run over {backend}")
        check([line.split()[-1] for line in log0.splitlines()
               if "ranks equal after step" in line] == ["1", "2"],
              "the trainer did not find the ranks equal after steps 1, 2")
        run1 = os.path.join(root, "one")
        os.environ["GEOT_LOG_STEP_LOSS"] = "1"
        buf = iolib.StringIO()
        ops.reset_launches()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                train_mod.parse_and_run([*common, f"run_dir={run1}"])
        finally:
            del os.environ["GEOT_LOG_STEP_LOSS"]
        one_s = time.perf_counter() - t
        counted()

        # each rank's kernel launches in each step against one process's
        per2, per1 = _step_launches(log0), _step_launches(buf.getvalue())
        check(len(per2) == len(per1) == 2 and all(
            len(r) == 2 and r[0] == r[1] == o[0] and o[0]["fps_cluster"] > 0
            and o[0]["knn_split"] > 0 for r, o in zip(per2, per1)),
            f"launches a step: two ranks {per2}, one process {per1}")
        for step in per2:
            for rank_counts in step:
                for k, v in rank_counts.items():
                    total[k] += v

        lr = float(FLAGSHIP_SEMI_CFG["lr"])
        (l2, ms2), (l1, ms1) = _steplosses(log0), _steplosses(buf.getvalue())
        one = {tag: _dp_state(run1, tag) for tag in ("E1", "latest")}
        check(len(l2) == len(l1) == 2 and one["latest"]["step"] == 2,
              f"step losses {l2} / {l1}")

        def readings(run, text):
            """The run against one process: the first and second steps'
            loss terms, the first moments after step 1, the weights after
            step 2."""
            losses, _ = _steplosses(text)
            e1, last = _dp_state(run, "E1"), _dp_state(run, "latest")
            check(len(losses) == 2 and last["step"] == 2,
                  f"{run}: step losses {losses}, step {last['step']}")
            m_err, m_at = _moment_err(e1["opt"], one["E1"]["opt"])
            rms, top = _weight_rms_lr(last["model"], one["latest"]["model"],
                                      lr)
            return {"first_loss": _rel_terms(losses[0], l1[0]),
                    "moments": m_err, "moments_worst_tensor": m_at,
                    "second_loss": _rel_terms(losses[1], l1[1]),
                    "weights": rms, "weights_max_lr": top,
                    "losses": losses}

        sound, ctl = readings(run2, log0), readings(*control)
        log(f"two ranks ({backend}, "
            f"{'one card each' if n_cards >= 2 else 'both on cuda:0'}) vs "
            f"one process, global batch 2 + 2 + 2 at 16,000 points, 2 "
            f"steps: " + "; ".join(
                f"{name}: first-step losses {r['first_loss']:.3e} apart, "
                f"first moments after step 1 {r['moments']:.3e} of their "
                f"scale (worst tensor {r['moments_worst_tensor']}), "
                f"second-step losses {r['second_loss']:.3e} apart, weights "
                f"after step 2 {r['weights']:.4f} lr rms "
                f"({r['weights_max_lr']:.3f} lr at most)"
                for name, r in (("sound", sound), ("rank-0-only control",
                                                    ctl))))
        log(f"step ms (to the losses on the host): two ranks {ms2}, one "
            f"process {ms1}; launches a step on each rank {per2[0][0]} (the "
            f"one process's too); runs {two_s:.1f} s and {one_s:.1f} s")
        check(sound["first_loss"] <= DP_FIRST_LOSS_RTOL,
              f"first step: two ranks {l2[0]}, one process {l1[0]}")
        for key, bound_ in (("moments", DP_MOMENT_TOL),
                            ("second_loss", DP_SECOND_LOSS_RTOL),
                            ("weights", DP_WEIGHT_RMS_LR)):
            check(sound[key] <= bound_, f"two ranks: {key} {sound[key]:.3e} "
                  f"past the bound {bound_:.3e}")
            check(ctl[key] > bound_, f"the control's {key} {ctl[key]:.3e} "
                  f"is within the bound {bound_:.3e}: the check cannot see "
                  f"a wrong reduction")
        out["dp"] = {"backend": backend, "sound": sound, "control": ctl,
                     "losses_one": l1, "step_ms_two": ms2, "step_ms_one": ms1,
                     "launches_a_step": per1[0][0], "seconds_two": two_s,
                     "seconds_one": one_s, "seconds_control": control_s}
    finally:
        for p, _ in control_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    check(all(total[k] > 0 for k in ("fps_cluster", "knn_split",
                                     *UPSAMPLE)),
          f"phase 14's paths launched {total}")
    log(f"phase 14 launches {total}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"kernels": {"fps_cluster": ops_rows[0],
                        "knn_split": ops_rows[1]}, "launches": total, **out}


# phase 15: GeoT's pretraining stage. viewgen.yaml at its own width; the
# cuts, each logged: epochs (60 -> 2), val_freq (10 -> 1) and save_freq
# (60 -> 1, for the epoch-1 checkpoint the resume starts from)
PRETRAIN_CUTS = ("epochs=2", "val_freq=1", "save_freq=1")
# ViewGenBase, the same weights, card against CPU (eval mode): loss
# relative, recon absolute
PRETRAIN_LOSS_RTOL = 1e-4
PRETRAIN_RECON_ATOL = 1e-3
# the manifest tree of the from-disk run: 4 train and 2 val clouds
_PRETRAIN_TREE = {"train": (0, 1, 2, 3), "val": (4, 5)}


def _write_png(path, rgb):
    """An 8-bit RGB PNG of ``rgb`` (H, W, 3) uint8, every row unfiltered,
    with the standard library's ``zlib``."""
    import struct
    import zlib

    h, w, _ = rgb.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _write_pretrain_tree(root, size):
    """A ``tooth_6000_pca`` manifest tree: 6 OBJ clouds of 40,000 points
    (``case<id>/case<id>_<jaw>.obj``), the 9 PCA views of each as 8-bit RGB
    PNG renders (depth splats of the normalised cloud), and
    ``<split>_pca_cur_0.5.json`` for ``train`` and ``val``. Returns the
    renders of cloud 0 as written (uint8)."""
    import numpy as np

    from geot_tpu_torch.data.data_util import rotate_theta_phi
    from geot_tpu_torch.data.tooth_pretrain import _PCA_ANGLES, _splat_render
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan, pc_norm

    table = rotate_theta_phi(_PCA_ANGLES)
    pcs, rgbs, first = [], [], None
    for i in range(6):
        case = os.path.join(root, f"case{i:04d}")
        rdir = os.path.join(case, "render")
        os.makedirs(rdir)
        name = f"case{i:04d}_{'lower' if i % 2 == 0 else 'upper'}"
        pts = _synthetic_scan(800 + i, 40000)[0]
        _write_obj(os.path.join(case, name + ".obj"), pts)
        norm = pc_norm(pts)[0].astype(np.float32)
        renders = [np.round(_splat_render(norm, v, size) * 255).astype(
            np.uint8) for v in table]
        for v, img in enumerate(renders):
            _write_png(os.path.join(rdir, f"{name}_{v}.png"), img)
        first = first if first is not None else renders
        pcs.append(os.path.join(case, name + ".obj"))
        rgbs.append(rdir)
    for split, which in _PRETRAIN_TREE.items():
        with open(os.path.join(root, f"{split}_pca_cur_0.5.json"), "w") as f:
            json.dump({"pc_data": [pcs[i] for i in which],
                       "rgb_data": [rgbs[i] for i in which]}, f)
    return first


def phase_pretrain(bound: Bound, smi: str):
    """Phase 15: GeoT's pretraining stage at ``viewgen.yaml``'s width."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.core.config import EasyConfig
    from geot_tpu_torch.data.build import build_dataloader_from_cfg
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path, load_variables
    from geot_tpu_torch.engine.pretrain import (make_pretrain_eval_step,
                                                make_pretrain_step,
                                                pretrain_batch)
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    log("phase 15: GeoT's pretraining stage (cfgs/tooth_pretrain/"
        "viewgen.yaml) at full width")
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    viewgen = os.path.join(here, "cfgs", "tooth_pretrain", "viewgen.yaml")
    flagship = os.path.join(here, "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    cfg = EasyConfig()
    cfg.load(viewgen, recursive=True)
    enc, gen = cfg.model.encoder_args, cfg.model.generator_args
    common = cfg.dataset.common
    log(f"viewgen.yaml: trans_dim {enc.trans_dim}, depth {enc.depth}, "
        f"{enc.num_group} groups of {enc.group_size}; {common.num_points} "
        f"points, batch {cfg.batch_size}, {common.n_views} views; "
        f"ViewTransformer depth {gen.depth}, {common.img_size} x "
        f"{common.img_size} renders; {cfg.sched} with warmup_epochs "
        f"{cfg.warmup_epochs}; cuts {list(PRETRAIN_CUTS)} (epochs "
        f"{cfg.epochs}, val_freq {cfg.val_freq}, save_freq {cfg.save_freq} "
        f"in the config)")
    dev = torch.device("cuda")
    B, N, G = int(cfg.batch_size), int(common.num_points), int(enc.num_group)
    # launches on this phase's main paths: all of them, and kernel 1's at
    # the pretraining shape, (B, N) -> G
    total = dict.fromkeys(ops.LAUNCHES, 0)
    at_shape = 0
    one = _launch_counts(fps_cluster=1)

    def counted():
        for k, v in ops.LAUNCHES.items():
            total[k] += v
        ops.reset_launches()

    loader = build_dataloader_from_cfg(B, cfg.dataset, None, split="train",
                                       seed=int(cfg.seed))
    loader.set_epoch(1)
    it = iter(loader)
    batches = [next(it) for _ in range(5)]
    val_loader = build_dataloader_from_cfg(B, cfg.dataset, None, split="val",
                                           seed=int(cfg.seed))
    vals = [b for _, b in zip(range(4), val_loader)]

    # kernel 1 at the tokenizer's shape: bit-equal, kernel-only time
    pos = torch.from_numpy(batches[0]["pos"]).to(dev).contiguous()
    got = ops.fps(pos, G)
    ref = ops.fps_ref(pos, G)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"fps ({B},{N})->{G}: indices differ from "
          f"fps_ref at {int((got != ref).sum())} places")
    ms = graph_ms(lambda: ops.fps(pos, G), 10)
    plain = cuda_ms(lambda: ops.fps_ref(pos, G), 1)
    b_ms, b_by = _fps_bound(bound, B, N, G)
    row = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": float((got.long() - ref.long()).abs().max())}
    log(f"fps ({B},{N})->{G}: bit-equal to fps_ref; kernel {ms:.4f} ms, "
        f"plain {plain:.1f} ms, bound {b_ms:.5f} ms ({b_by})")
    ops.reset_launches()

    # timed steps and validation batches
    state = TrainState.create(cfg, cfg.model, seed=int(cfg.seed), device=dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    step = make_pretrain_step(cfg)
    eval_step = make_pretrain_eval_step()
    lr = build_scheduler_from_cfg(cfg)(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step_ms = []
    for n, b in enumerate(batches):
        b = pretrain_batch(b, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(step(state, b, lr)["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        check(math.isfinite(loss), f"pretrain step {n}: loss {loss}")
        check(dict(ops.LAUNCHES) == one, f"pretrain step {n}: launches "
              f"{dict(ops.LAUNCHES)}, expected {one}")
        at_shape += 1
        counted()
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
    # device time by kernel and the card's idle share of a step: a warm-up
    # and 2 profiled steps, a launch each
    b1 = pretrain_batch(batches[1], dev)
    wall, busy = _profile("pretrain step", lambda: step(state, b1, lr), 2,
                          top=10)
    want_p = _launch_counts(fps_cluster=3)
    check(dict(ops.LAUNCHES) == want_p, f"profiled pretrain steps: "
          f"launches {dict(ops.LAUNCHES)}, expected {want_p}")
    at_shape += 3
    counted()
    val_ms = []
    for n, b in enumerate(vals):
        b = pretrain_batch(b, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        v = float(eval_step(state.model, b))
        torch.cuda.synchronize()
        val_ms.append((time.perf_counter() - t) * 1e3)
        check(math.isfinite(v), f"pretrain val batch {n}: loss {v}")
        check(dict(ops.LAUNCHES) == one, f"pretrain val batch {n}: launches "
              f"{dict(ops.LAUNCHES)}, expected {one}")
        at_shape += 1
        counted()
    step_med = statistics.median(step_ms[1:])
    val_med = statistics.median(val_ms[1:])
    log(f"pretrain: {n_params} parameters; steps "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms (median after the "
        f"first {step_med:.2f} ms), val batches "
        f"{', '.join(f'{x:.1f}' for x in val_ms)} ms (median after the "
        f"first {val_med:.2f} ms), peak memory {peak_mb:.0f} MiB above the "
        f"resident {resident / 2 ** 20:.0f} MiB; {smi}")

    # the same weights and batch on the card and on the CPU
    b = vals[0]
    state.model.eval()
    with torch.no_grad():
        loss_g, rec_g = state.model(pretrain_batch(b, dev))
        torch.cuda.synchronize()
        at_shape += 1
        counted()
        cpu_model = copy.deepcopy(state.model).cpu().eval()
        t = time.perf_counter()
        loss_c, rec_c = cpu_model(pretrain_batch(b, "cpu"))
        cpu_s = time.perf_counter() - t
    d_loss = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    d_rec = float((rec_g.cpu() - rec_c).abs().max())
    check(d_loss <= PRETRAIN_LOSS_RTOL and d_rec <= PRETRAIN_RECON_ATOL,
          f"pretrain forward card vs CPU: loss {float(loss_g)} vs "
          f"{float(loss_c)} ({d_loss:.2e} relative), recon max |d| {d_rec}")
    log(f"pretrain forward card vs CPU: loss {float(loss_g):.8f} vs "
        f"{float(loss_c):.8f} ({d_loss:.2e} relative, bound "
        f"{PRETRAIN_LOSS_RTOL}), recon max |d| {d_rec:.2e} (bound "
        f"{PRETRAIN_RECON_ATOL}); CPU forward {cpu_s:.1f} s")
    del state, cpu_model
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="geot_pretrain_")
    out = {}
    try:
        # the trainer: 2 epochs, then a resume from epoch 1
        sched = build_scheduler_from_cfg(cfg)
        steps = len(loader)
        n_val = len(val_loader)
        t = time.perf_counter()
        res = train_mod.parse_and_run(["--cfg", viewgen, *PRETRAIN_CUTS,
                                       f"root_dir={root}", "device=cuda"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        want = _launch_counts(fps_cluster=2 * (steps + n_val))
        check(dict(ops.LAUNCHES) == want, f"pretrain trainer launches "
              f"{dict(ops.LAUNCHES)}, expected {want}")
        at_shape += 2 * (steps + n_val)
        counted()
        (run_dir,) = [os.path.join(root, "tooth_pretrain", d)
                      for d in os.listdir(os.path.join(root,
                                                       "tooth_pretrain"))]
        name = os.path.basename(run_dir)
        ck = os.path.join(run_dir, "checkpoint")
        with open(os.path.join(run_dir, "scalars.jsonl")) as fh:
            sc = [json.loads(x) for x in fh]
        lrs = {d["step"]: d["value"] for d in sc if d["tag"] == "lr"}
        check(lrs == {1: sched(1), 2: sched(2)}, f"pretrain lr by epoch "
              f"{lrs}, the schedule's {sched(1)}, {sched(2)}")
        losses = {d["step"]: d["value"] for d in sc
                  if d["tag"] == "train_loss"}
        check(len(losses) == 2 and all(map(math.isfinite, losses.values())),
              f"pretrain train losses {losses}")
        for tag in ("latest", "best", "E1", "E2"):
            check(os.path.exists(ckpt_path(ck, name, tag)),
                  f"pretrain: no {tag} checkpoint")
        e1 = ckpt_path(ck, name, "E1")
        t = time.perf_counter()
        res_b = train_mod.parse_and_run(["--cfg", viewgen, *PRETRAIN_CUTS,
                                         "mode=resume",
                                         f"pretrained_path={e1}",
                                         f"root_dir={root}", "device=cuda"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        want_b = _launch_counts(fps_cluster=steps + n_val)
        check(dict(ops.LAUNCHES) == want_b, f"pretrain resume launches "
              f"{dict(ops.LAUNCHES)}, expected {want_b}")
        at_shape += steps + n_val
        counted()
        with open(os.path.join(run_dir, "scalars.jsonl")) as fh:
            sc_b = [json.loads(x) for x in fh][len(sc):]
        check({d["step"] for d in sc_b} == {2}, f"the resume wrote epochs "
              f"{sorted({d['step'] for d in sc_b})}, expected [2]")
        lr_b = [d["value"] for d in sc_b if d["tag"] == "lr"]
        check(lr_b == [sched(2)], f"resumed lr {lr_b}")
        b2 = {d["tag"]: d["value"] for d in sc_b}
        log(f"pretrain trainer: {run_s:.1f} s for 2 epochs of {steps} steps "
            f"and {n_val} val batches; lr {lrs}; train loss {losses}; val "
            f"loss {res['val_loss']:.6f}, best {res['best']}; resume from "
            f"E1 {resume_s:.1f} s: epoch 2 train loss {b2['train_loss']:.6f}"
            f" (uninterrupted {losses[2]:.6f}), val {res_b['val_loss']:.6f}")
        best = ckpt_path(ck, name, "best")

        # one epoch from a manifest tree: OBJ clouds and PNG renders
        tree = os.path.join(root, "tree")
        written = _write_pretrain_tree(tree, int(common.img_size))
        ds = build_dataloader_from_cfg(B, {"common": dict(
            common, data_root=tree)}, None, split="train", seed=0).dataset
        check(not ds.synthetic and len(ds) == 4, "the manifest tree was "
              "not read")
        ds.epoch = 1
        item = ds[0]
        rng = ds._rng(0)
        ds._point_payload(0, rng)
        views = ds._views_for(ds.file_list[0], rng)[0]
        check(all(np.array_equal(item["imgs"][j],
                                 written[v].astype(np.float32) / 255)
                  for j, v in enumerate(views)),
              "the PNG renders read back differ from those written")
        t = time.perf_counter()
        res_d = train_mod.parse_and_run(["--cfg", viewgen, "epochs=1",
                                         f"dataset.common.data_root={tree}",
                                         f"root_dir={root}/disk",
                                         "device=cuda"])
        torch.cuda.synchronize()
        disk_s = time.perf_counter() - t
        want_d = _launch_counts(fps_cluster=len(_PRETRAIN_TREE["train"])
                                // B + len(_PRETRAIN_TREE["val"]) // B)
        check(dict(ops.LAUNCHES) == want_d, f"pretrain from disk launches "
              f"{dict(ops.LAUNCHES)}, expected {want_d}")
        check(math.isfinite(res_d["val_loss"]), f"from disk: val loss "
              f"{res_d['val_loss']}")
        at_shape += sum(want_d.values())
        counted()
        log(f"pretrain from a manifest tree (6 OBJ clouds of 40,000 points, "
            f"9 PNG renders each): views {[int(v) for v in views]} of cloud 0 "
            f"read back "
            f"bit-equal; 1 epoch {disk_s:.1f} s, val loss "
            f"{res_d['val_loss']:.6f}")

        # the graft into the flagship, one semi step of 2 + 2 + 2
        teeth = os.path.join(root, "teeth3ds")
        os.makedirs(teeth)
        _write_teeth3ds(teeth, [(f"P{i:03d}", i % 2,
                                 *_synthetic_scan(600 + i, 40000))
                                for i in range(6)], _DP_SPLITS)
        enc_sd = {k[len("encoder."):]: v for k, v in
                  load_variables(best, False).items()
                  if k.startswith("encoder.")}
        seen = {}
        real_step, real_graft = (train_mod.make_semi_step,
                                 train_mod.load_pretrain_encoder)

        def graft(*args, **kwargs):
            merged, skipped = real_graft(*args, **kwargs)
            seen["skipped"] = skipped
            return merged, skipped

        def make(cfg_):
            semi_step = real_step(cfg_)

            def first(state_, *args, **kwargs):
                for who, m in (("student", state_.model),
                               ("teacher", state_.teacher)):
                    sd = m.state_dict()
                    bad = [k for k, v in enc_sd.items()
                           if not torch.equal(sd["segmentor." + k].cpu(), v)]
                    check(not bad, f"graft: the {who}'s trunk differs from "
                          f"the checkpoint at {bad[:3]}")
                counted()
                m_ = semi_step(state_, *args, **kwargs)
                torch.cuda.synchronize()
                seen["step"] = dict(ops.LAUNCHES)
                seen["losses"] = {k: float(m_[k]) for k in
                                  ("loss", "sup_loss", "unsup_loss")}
                counted()
                return m_

            return first

        train_mod.make_semi_step = make
        train_mod.load_pretrain_encoder = graft
        try:
            t = time.perf_counter()
            res_f = train_mod.parse_and_run([
                "--cfg", flagship, f"dataset_l.common.data_root={teeth}",
                f"dataset_u.common.data_root={teeth}", "epochs=1",
                "val_freq=1", "test_freq=1", f"pretrain_encoder_path={best}",
                f"root_dir={root}/ft", "device=cuda"])
            torch.cuda.synchronize()
            ft_s = time.perf_counter() - t
        finally:
            train_mod.make_semi_step = real_step
            train_mod.load_pretrain_encoder = real_graft
        counted()
        check(seen.get("skipped") == [], f"graft skipped "
              f"{seen.get('skipped')}")
        trunk = {k.split(".", 1)[0] for k in enc_sd}
        check(trunk == {"encoder", "reduce_dim", "pos_embed", "blocks",
                        "norm"}, f"the checkpoint's encoder holds {trunk}")
        want_s = _launch_counts(**_PER_STEP)
        check(seen["step"] == want_s, f"the grafted step's launches "
              f"{seen['step']}, phase 6's step {want_s}")
        check(all(map(math.isfinite, seen["losses"].values())),
              f"the grafted step's losses {seen['losses']}")
        for split in ("val", "test"):
            # one lower-jaw scan: the maxillary metrics are NaN
            bad = {k: v for k, v in res_f[split].items()
                   if k.startswith("whole_")
                   and not (math.isfinite(v) and 0.0 <= v <= 1.0)}
            check(not bad, f"grafted finetune: {split} metrics {bad}")
        log(f"graft: {len(enc_sd)} trunk entries of {os.path.basename(best)}"
            f" in the student and the teacher, nothing skipped; one semi "
            f"step of 2 + 2 + 2: launches {seen['step']}, losses "
            f"{seen['losses']}; the run {ft_s:.1f} s")
        out.update(run_s=run_s, resume_s=resume_s, disk_s=disk_s, ft_s=ft_s,
                   finetune_losses=seen["losses"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{total}")
    out.update(kernels={"fps_pretrain": dict(row, launches=at_shape)},
               launches=total, params=n_params, step_ms=step_ms,
               step_median_ms=step_med, val_ms=val_ms,
               val_median_ms=val_med, peak_mb=peak_mb,
               profile_wall_ms=wall, profile_busy_ms=busy,
               card_vs_cpu={"loss_rel": d_loss, "recon_abs": d_rec})
    return out


# phase 16: the trainer's other switches at full width. (a) every
# registered optimizer, lookahead and layer decay: 3 updates on the card
# and on the CPU from phase 6's gradients, the weights within SW_OPT_TOL of
# each tensor's largest entry, then a full-width semi step each
SW_OPT_TOL = 1e-5
SW_EXTRA = (("lookahead_adamw", {"lookahead_k": 2}),
            ("adamw", {"layer_decay": 0.75}))
# (b) the Hessian diagonal, card against CPU in float64 at 1 + 1 + 1 clouds
# from the same z: phase 6's float64 gradient bound
SW_HESS_TOL = 1e-3
# (c) the trainer with the switches, on phase 13's Teeth3DS tree: 3 steps of
# 2 + 2 + 2 an epoch (6 labelled scans), an update every 2 steps, so the
# epoch ends one gradient into a group
SW_TRAINER = ("optimizer.NAME=lookahead_adamw", "optimizer.layer_decay=0.75",
              "step_per_update=2", "profile_epoch=1",
              "eval_device_cache=False", "wandb.use_wandb=True")
_SW_SPLITS = {"semi_l_train_0.2.txt": (0, 1, 2, 3, 4, 5),
              "semi_u_train_0.2.txt": (0, 1, 2, 3, 4, 5),
              "testing.txt": (0, 5),
              "full_train_finetune_0.1.txt": (0, 1, 2, 3, 4, 5),
              "full_val_finetune.txt": (0, 5),
              "full_test_finetune.txt": (0, 5)}
# (d) pretraining over two ranks against one process: phase 14's bounds on
# the first step's loss and the weights after step 2; stochastic depth off,
# as in phase 14 (a rank draws its own block's masks, one process the
# global batch's: on the card they are other numbers)
SW_PRETRAIN_CUTS = ("epochs=1", "val_freq=1", "warmup_epochs=0",
                    "model.encoder_args.drop_path_rate=0.0")
# the control's ranks reduce nothing: each takes its own rows' loss sums
# and BatchNorm statistics, and rank 0's gradient (times the world) stands
# for the sum
_PRETRAIN_CONTROL = r"""
import sys
from geot_tpu_torch.engine import train
from geot_tpu_torch.parallel import dist


def rank0_only(params):
    for p in params:
        dist.broadcast_(p.grad)
        p.grad.mul_(dist.world())


dist.all_reduce_sum = lambda x: x
dist.gather = lambda x: x
dist.sum_gradients = rank0_only
train.parse_and_run(sys.argv[1:])
dist.shutdown()
"""


def _hessian_cpu_case():
    """The float64 AdaHessian semi step's inputs, the same in every process:
    a seeded state at 1 + 1 + 1 clouds (``CMP_TRUNK``), its batch, and ``z``
    from a seeded CPU generator by parameter name."""
    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG
    from geot_tpu_torch.data.build import build_semi_loaders, semi_pairs
    from geot_tpu_torch.optim import rademacher

    cfg = dict(FLAGSHIP_SEMI_CFG, batch_size_l=1, batch_size_u=1,
               optimizer=dict(FLAGSHIP_SEMI_CFG["optimizer"],
                              NAME="adahessian"))
    seg = dict(FLAGSHIP_SEG_ARGS, **CMP_TRUNK)
    loaders = build_semi_loaders(cfg)
    for loader in loaders:
        loader.set_epoch(1)
    batch = next(semi_pairs(*loaders, limit=1))
    return cfg, seg, batch, rademacher


def _hessian_step(device):
    """``_hessian_cpu_case``'s step on ``device`` in float64: (loss terms,
    name -> |Hessian diagonal|, name -> first moment), on the host."""
    import torch

    from geot_tpu_torch.data.build import MODEL_KEYS, SEMI_KEYS, to_device
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    cfg, seg, (bl, bu), rademacher = _hessian_cpu_case()
    st = SemiTrainState.create(cfg, seg_args=seg, seed=1, device=device)
    for mod in (st.model, st.teacher, st.t_predictor):
        mod.double()
    st.ema_t, st.cm = st.ema_t.double(), st.cm.double()
    named = list(st.model.named_parameters()) + list(
        st.t_predictor.named_parameters())
    gen = torch.Generator().manual_seed(16)
    zs = dict(zip([n for n, _ in named], rademacher(
        [p.detach().cpu() for _, p in named], gen)))
    batches = [{k: (v.double() if v.is_floating_point() else v)
                for k, v in to_device(b, keys, device).items()}
               for b, keys in ((bl, MODEL_KEYS), (bu, SEMI_KEYS))]
    m = make_semi_step(cfg)(st, *batches, 1e-3, True,
                            draws={"hessian": zs})
    b2 = float(dict(cfg["optimizer"]).get("betas", (0.9, 0.999))[1])
    diag, mu = {}, {}
    for n, p in named:
        opt = st.t_opt if n.startswith("T_predictor.") else st.opt
        s = opt.state[p]
        diag[n] = (s["exp_hessian_diag_sq"].cpu() / (1 - b2)).sqrt()
        mu[n] = s["exp_avg"].cpu()
    return ({k: float(m[k]) for k in ("loss", "sup_loss", "unsup_loss",
                                      "threed_loss")}, diag, mu)


def hessian_cpu(path: str, memo: str | None = None) -> int:
    """``--hessian-cpu PATH [MEMO]`` (phase 16 runs it in a child process,
    beside the card's work): ``_hessian_step`` on the CPU, saved to PATH,
    with the searches of MEMO (``cpu_search_memo.save``) known."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t = time.perf_counter()
    with cpu_search_memo(load=memo):
        out = _hessian_step("cpu")
    torch.save({"out": out, "seconds": time.perf_counter() - t,
                "searches": dict(_SEARCH_STATS)}, path)
    return 0


def _rel_max(got, ref, skip=()):
    """The worst tensor's max |got - ref| over the tensor's largest |ref|,
    and its name; the tensors ``skip`` names must vanish instead (at most
    1e-4 of the largest entry of all, in both)."""
    gmax = max(float(v.abs().max()) for v in ref.values())
    worst = (0.0, "")
    for k in skip:
        check(float(got[k].abs().max()) <= 1e-4 * gmax
              and float(ref[k].abs().max()) <= 1e-4 * gmax,
              f"{k} should vanish")
    for k, v in ref.items():
        if k in skip:
            continue
        scale = max(float(v.abs().max()), 1e-300)
        worst = max(worst, (float((got[k].double().cpu()
                                   - v.double()).abs().max()) / scale, k))
    return worst


def _pretrain_steplosses(text):
    """The ``steploss`` lines of a pretraining log: the losses and the
    steps' milliseconds."""
    rows = [line.split(" steploss ")[1].split()
            for line in text.splitlines() if " steploss " in line]
    return [float(r[1]) for r in rows], [float(r[3]) for r in rows]


def phase_switches(bound: Bound, train):
    """Phase 16: the trainer's other switches at full width (a)-(e)."""
    import contextlib
    import copy
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data.build import MODEL_KEYS, SEMI_KEYS, to_device
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step
    from geot_tpu_torch.engine.writer import Wandb
    from geot_tpu_torch.optim import build_optimizer_from_cfg
    from geot_tpu_torch.optim.factory import _OPTIMIZERS

    log("phase 16: the trainer's other switches at full width")
    t_phase = time.perf_counter()
    # the card's machine has a wandb package and no network: blocked, so
    # that wandb.use_wandb takes the facade's no-op path (the real package
    # would try to reach its servers)
    sys.modules["wandb"] = None
    here = os.path.dirname(os.path.abspath(__file__))
    flagship = os.path.join(here, "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    viewgen = os.path.join(here, "cfgs", "tooth_pretrain", "viewgen.yaml")
    sup = os.path.join(here, "cfgs", "tooth_sup", "transformer.yaml")
    root = tempfile.mkdtemp(prefix="geot_switches_")
    dev = torch.device("cuda")
    cfg = FLAGSHIP_SEMI_CFG
    total = dict.fromkeys(ops.LAUNCHES, 0)
    out = {}
    children = []

    def counted():
        for k, v in ops.LAUNCHES.items():
            total[k] += v
        ops.reset_launches()

    try:
        # (b)'s CPU side, in a child beside the card's work
        hess_path = os.path.join(root, "hessian_cpu.pt")
        hess_out = open(os.path.join(root, "hessian_cpu.out"), "w")
        # the searches of phase 6's CPU steps, whose clouds (b) shares
        memo_path = os.path.join(root, "cpu_searches.pt")
        cpu_search_memo.save(memo_path)
        hess_child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--hessian-cpu",
             hess_path, memo_path], cwd=here, stdout=hess_out,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="4"))
        children.append(hess_child)

        # (a) the optimizer family from phase 6's gradients
        model = train["state"].model
        grads = train["grads"]
        w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        mc = copy.deepcopy(model)
        mp = copy.deepcopy(model).cpu()
        gc = [grads[n] for n, _ in mc.named_parameters()]
        gp = [grads[n].cpu() for n, _ in mp.named_parameters()]
        lr = float(cfg["lr"])
        lrs = (lr, lr, lr / 2)
        base = {k: v for k, v in cfg["optimizer"].items() if k != "NAME"}
        cases = [(n, {}) for n in sorted(_OPTIMIZERS)] + list(SW_EXTRA)
        opt_rows = {}
        for name, extra in cases:
            label = name + "".join(f" {k}={v}" for k, v in extra.items())
            ms = []
            for m, g in ((mc, gc), (mp, gp)):
                with torch.no_grad():
                    for n, p in m.named_parameters():
                        p.copy_(w0[n])
                opt = build_optimizer_from_cfg(m, lr, NAME=name,
                                               **base, **extra)
                order = {id(p): i for i, p in enumerate(m.parameters())}
                hess = [g[order[id(p)]] for p in opt.params()]
                for p, gi in zip(m.parameters(), g):
                    p.grad = gi
                for step_lr in lrs:
                    for grp in opt.param_groups:
                        grp["lr"] = step_lr
                    if m is mc:
                        torch.cuda.synchronize()
                    t = time.perf_counter()
                    opt.step(hessian=hess if opt.needs_hessian else None)
                    if m is mc:
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t) * 1e3)
            cpu = dict(mp.named_parameters())
            err, at = _rel_max({n: p.detach()
                                for n, p in mc.named_parameters()},
                               {n: p.detach() for n, p in cpu.items()})
            moved = sum(not torch.equal(p.detach().cpu(), w0[n].cpu())
                        for n, p in mc.named_parameters())
            opt_rows[label] = {"max_rel_err": err, "update_ms": ms}
            log(f"(a) {label}: 3 updates card vs CPU, worst tensor "
                f"{err:.2e} ({at}); {moved}/{len(w0)} tensors moved; card "
                f"update ms " + ", ".join(f"{x:.2f}" for x in ms))
            check(err <= SW_OPT_TOL, f"(a) {label}: card and CPU weights "
                  f"differ by {err:.3e} of a tensor's scale ({at})")
            check(moved > 0.5 * len(w0), f"(a) {label}: {moved} tensors "
                  f"moved")
        del mc, mp
        # one full-width semi step each, 2 + 2 + 2 clouds
        st = SemiTrainState.create(cfg, seed=0, device=dev)
        st.cm = train["state"].cm.clone()
        bl, bu = train["pairs"][0]
        bl, bu = to_device(bl, MODEL_KEYS, dev), to_device(bu, SEMI_KEYS, dev)
        for name, extra in cases:
            label = name + "".join(f" {k}={v}" for k, v in extra.items())
            ocfg = dict(cfg, optimizer=dict(cfg["optimizer"], NAME=name,
                                            **extra))
            st.opt = build_optimizer_from_cfg(st.model, lr,
                                              **ocfg["optimizer"])
            st.t_opt = build_optimizer_from_cfg(st.t_predictor, lr,
                                                **ocfg["optimizer"])
            before = {n: p.detach().clone()
                      for n, p in st.model.named_parameters()}
            counted()
            m = make_semi_step(ocfg)(st, bl, bu, lr, True)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            counted()
            terms = {k: float(m[k]) for k in ("loss", "sup_loss",
                                              "unsup_loss", "threed_loss")}
            moved = sum(not torch.equal(before[n], p)
                        for n, p in st.model.named_parameters())
            check(all(math.isfinite(v) for v in terms.values()),
                  f"(a) {label} semi step: a loss is not finite {terms}")
            check(moved > 0.5 * len(before), f"(a) {label} semi step: "
                  f"{moved}/{len(before)} tensors moved")
            check(launches == _launch_counts(**_PER_STEP),
                  f"(a) {label} semi step launches {launches}")
            opt_rows[label]["semi_step_loss"] = terms["loss"]
        log(f"(a) one full-width semi step with each of {len(cases)} "
            f"optimizers: losses finite, weights moved, phase 6's launches")
        out["optimizers"] = opt_rows

        # (b) AdaHessian: 3 flagship steps at 2 + 2 + 2 x 16,000 points
        hcfg = dict(cfg, optimizer=dict(cfg["optimizer"], NAME="adahessian"))
        st.opt = build_optimizer_from_cfg(st.model, lr, **hcfg["optimizer"])
        st.t_opt = build_optimizer_from_cfg(st.t_predictor, lr,
                                            **hcfg["optimizer"])
        hstep = make_semi_step(hcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        h_ms, h_launch = [], []
        for pair in train["pairs"]:
            b_l = to_device(pair[0], MODEL_KEYS, dev)
            b_u = to_device(pair[1], SEMI_KEYS, dev)
            counted()
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = hstep(st, b_l, b_u, lr, True)
            torch.cuda.synchronize()
            h_ms.append((time.perf_counter() - t) * 1e3)
            h_launch.append(dict(ops.LAUNCHES))
            counted()
            check(math.isfinite(float(m["loss"])), "(b) loss not finite")
        h_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        adamw_ms = statistics.median(train["step_ms"])
        log(f"(b) AdaHessian flagship steps: "
            f"{', '.join(f'{x:.1f}' for x in h_ms)} ms (median {statistics.median(h_ms):.1f}) against phase 6's "
            f"AdamW {adamw_ms:.1f}; peak memory {h_peak:.0f} MiB against "
            f"{train['peak_mb']:.0f}; launches a step {h_launch}")
        for c in h_launch:
            check(c == _launch_counts(**_PER_STEP), f"(b) launches {c}, "
                  f"expected phase 6's {_PER_STEP}")
        del st
        torch.cuda.empty_cache()
        t = time.perf_counter()
        card_terms, card_diag, card_mu = _hessian_step(dev)
        card_s = time.perf_counter() - t
        counted()
        out["adahessian"] = {"step_ms": h_ms, "peak_mb": h_peak,
                             "adamw_step_ms": adamw_ms,
                             "float64_card_s": card_s}

        # (c) the trainer with the switches, then the deterministic resume
        tree = os.path.join(root, "teeth3ds")
        os.makedirs(tree)
        _write_teeth3ds(tree, [(i, jaw, *_synthetic_scan(seed, n))
                               for i, jaw, seed, n in _FILES_SCANS[:6]],
                        _SW_SPLITS)
        data = [f"dataset_l.common.data_root={tree}",
                f"dataset_u.common.data_root={tree}"]
        common = [f"root_dir={os.path.join(root, 'trainer')}", "epochs=2",
                  "val_freq=1", "test_freq=2", "save_freq=1", *data,
                  *SW_TRAINER]
        counted()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = train_mod.parse_and_run(["--cfg", flagship, *common])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches_c = dict(ops.LAUNCHES)
        counted()
        run_dir = os.path.join(root, "trainer", "tooth_semi", os.listdir(
            os.path.join(root, "trainer", "tooth_semi"))[0])
        traces = os.listdir(os.path.join(run_dir, "trace"))
        text = open(os.path.join(run_dir, "trace", traces[0])).read()
        names = {k: k in text for k in ("fps_cluster", "knn_split")}
        want = _expected(steps=6, cm_batches=3, eval_batches=3)
        log(f"(c) trainer with {list(SW_TRAINER)}: {wall:.1f} s, val whole "
            f"miou {res['val']['whole_miou']:.4f}; trace {traces} "
            f"({len(text)} bytes) names {names}; wandb run "
            f"{Wandb.run}; launches {launches_c}")
        check(traces == ["epoch1.json"] and all(names.values()),
              f"(c) the trace {traces} does not name the kernels: {names}")
        check(launches_c == want, f"(c) launches {launches_c}, expected "
              f"{want} (6 steps, 3 cm batches, 3 eval batches)")
        check(Wandb.run is None, "(c) wandb should be a no-op here")
        det = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--resume-check",
             os.path.join(root, "deterministic"), *data, *SW_TRAINER],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ,
                                CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        children.append(det)

        # (d) pretraining: two ranks through engine.launch, one process,
        # and the control, on a manifest tree of 4 train clouds (2 steps)
        ptree = os.path.join(root, "pretrain_tree")
        os.makedirs(ptree)
        _write_pretrain_tree(ptree, 128)
        popts = ["--cfg", viewgen, f"dataset.common.data_root={ptree}",
                 *SW_PRETRAIN_CUTS]
        # the ranks' cuDNN convolutions without TF32, as in this process
        env = dict(_rank_env(here), NVIDIA_TF32_OVERRIDE="0")
        ctrl_run = os.path.join(root, "pretrain_control")
        os.makedirs(ctrl_run)
        ctrl = []
        for r in range(2):
            f = open(os.path.join(ctrl_run, f"rank{r}.out"), "w")
            ctrl.append((subprocess.Popen(
                [sys.executable, "-c", _PRETRAIN_CONTROL, *popts,
                 f"run_dir={ctrl_run}", "run_name=control"], cwd=here,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=f,
                stderr=subprocess.STDOUT), f))
            children.append(ctrl[-1][0])
        one = os.path.join(root, "pretrain_one")
        counted()
        os.environ["GEOT_LOG_STEP_LOSS"] = "1"
        log_buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(log_buf):
                train_mod.parse_and_run([*popts, f"run_dir={one}",
                                         "run_name=one"])
        finally:
            del os.environ["GEOT_LOG_STEP_LOSS"]
        launches_one = dict(ops.LAUNCHES)
        counted()
        two = os.path.join(root, "pretrain_two")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "geot_tpu_torch.engine.launch",
             "--nprocs", "2", "--run-dir", two, "--", *popts], cwd=here,
            env=dict(os.environ, GEOT_LOG_STEP_LOSS="1", PYTHONPATH=here,
                     NVIDIA_TF32_OVERRIDE="0"),
            capture_output=True, text=True, timeout=600)
        two_s = time.perf_counter() - t
        check(proc.returncode == 0, "(d) two-rank pretraining failed: "
              + proc.stdout[-3000:] + proc.stderr[-3000:])
        _, ctrl_text = _wait_control(ctrl_run, ctrl)
        rank0 = open(os.path.join(two, "rank0.log")).read()
        l_one, ms_one = _pretrain_steplosses(log_buf.getvalue())
        l_two, ms_two = _pretrain_steplosses(rank0)
        l_ctrl, _ = _pretrain_steplosses(ctrl_text)
        rank_launches = _step_launches(rank0)
        check(len(l_one) == len(l_two) == len(l_ctrl) == 2,
              f"(d) step losses {l_one} {l_two} {l_ctrl}")
        w_one = _dp_state(one, "latest")["model"]
        plr = 5e-4
        loss_rel = abs(l_two[0] - l_one[0]) / abs(l_one[0])
        ctrl_rel = abs(l_ctrl[0] - l_one[0]) / abs(l_one[0])
        w_rms, w_top = _weight_rms_lr(_dp_state(two, "latest")["model"],
                                      w_one, plr)
        c_rms, c_top = _weight_rms_lr(_dp_state(ctrl_run, "latest")["model"],
                                      w_one, plr)
        log(f"(d) two-rank pretraining (launch, {two_s:.1f} s) vs one "
            f"process: first-step loss {loss_rel:.3e} relative (control "
            f"{ctrl_rel:.3e}), weights after step 2 {w_rms:.4f} lr rms, max "
            f"{w_top:.4f} (control {c_rms:.4f}, {c_top:.4f}); step ms two "
            f"ranks {ms_two}, one process {ms_one}; one process launches "
            f"{launches_one}; ranks' launches a step {rank_launches}")
        check(loss_rel <= DP_FIRST_LOSS_RTOL and w_rms <= DP_WEIGHT_RMS_LR,
              "(d) two ranks differ from one process")
        check(ctrl_rel > DP_FIRST_LOSS_RTOL and c_rms > DP_WEIGHT_RMS_LR,
              "(d) the control passed a bound")
        check(all(r == _launch_counts(fps_cluster=1)
                  for step_ in rank_launches for r in step_),
              f"(d) each rank launches one fps_cluster a step: "
              f"{rank_launches}")
        out["pretrain_dp"] = {"loss_rel": loss_rel, "weight_rms_lr": w_rms,
                              "control_loss_rel": ctrl_rel,
                              "control_weight_rms_lr": c_rms,
                              "launch_s": two_s, "step_ms_two": ms_two,
                              "step_ms_one": ms_one}

        # (e) TeethSegFinetuneDataset through the supervised transformer
        t = time.perf_counter()
        res_e = train_mod.parse_and_run([
            "--cfg", sup, f"root_dir={os.path.join(root, 'finetune')}",
            "epochs=1", "dataset_l.common.NAME=TeethSegFinetuneDataset",
            f"dataset_l.common.data_root={tree}"])
        launches_e = dict(ops.LAUNCHES)
        counted()
        bad = {k: v for k, v in res_e["val"].items()
               if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
        log(f"(e) TeethSegFinetuneDataset through cfgs/tooth_sup/"
            f"transformer.yaml: {time.perf_counter() - t:.1f} s, val whole "
            f"miou {res_e['val']['whole_miou']:.4f}; launches {launches_e}")
        check(not bad, f"(e) metrics outside [0, 1]: {bad}")

        # the children: the deterministic resume and the CPU's Hessian
        det_out, det_err = det.communicate(timeout=600)
        check(det.returncode == 0, "(c) the deterministic resume failed: "
              + det_err[-3000:])
        pair = json.loads([line for line in det_out.splitlines()
                           if line.startswith("RESUME_CHECK ")][-1][13:])
        tags = [k for k in pair["a"] if k not in ("epoch_seconds",
                                                  "data_seconds")]
        unequal = {k: (pair["a"][k], pair["b"].get(k)) for k in tags
                   if pair["b"].get(k) != pair["a"][k]}
        log(f"(c) deterministic resume from E1, one gradient into a group: "
            f"{len(tags) - len(unequal)}/{len(tags)} epoch-2 scalars "
            f"bit-equal")
        check(len(tags) >= 40 and not unequal, f"(c) the resume differs: "
              f"{unequal}")
        t = time.perf_counter()
        hess_child.wait(timeout=900)
        hess_out.close()
        check(hess_child.returncode == 0, "(b) the CPU's Hessian step "
              "failed: " + open(hess_out.name).read()[-3000:])
        saved = torch.load(hess_path, weights_only=False)
        cpu_terms, cpu_diag, cpu_mu = saved["out"]
        rel = {k: abs(card_terms[k] - v) / max(abs(v), 1e-30)
               for k, v in cpu_terms.items()}
        # a bias before BatchNorm: no gradient, no curvature (phase 6)
        d_err, d_at = _rel_max(card_diag, cpu_diag, _ZERO_GRAD)
        g_err, g_at = _rel_max(card_mu, cpu_mu, _ZERO_GRAD)
        log(f"(b) float64, 1 + 1 + 1 clouds, the same z: card {card_s:.1f} "
            f"s, CPU {saved['seconds']:.1f} s in its child (searches "
            f"{saved['searches']}; waited {time.perf_counter() - t:.1f} s); "
            f"loss terms relative "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f"; |diag| worst tensor {d_err:.3e} ({d_at}); first moment "
            f"{g_err:.3e} ({g_at})")
        check(all(v <= 1e-4 for v in rel.values()), f"(b) loss terms {rel}")
        check(d_err <= SW_HESS_TOL and g_err <= SW_HESS_TOL,
              f"(b) the card's Hessian diagonal differs from the CPU's: "
              f"{d_err:.3e} ({d_at}), first moment {g_err:.3e}")
        out["adahessian"].update(diag_rel=d_err, grad_rel=g_err,
                                 float64_cpu_s=saved["seconds"])
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
        shutil.rmtree(root, ignore_errors=True)
    counted()
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['seconds']:.1f} s; launches {total}")
    return out


# phase 17: the heritage tasks (task: cls | partseg) at the published widths
# and batches of cfgs/scanobjectnn and cfgs/shapenetpart on the synthetic
# ScanObjectNN (64 clouds a split) and ShapeNetPart (32 shapes) sets
HERITAGE = ("pointnet2cls", "dgcnncls", "pointmlpcls", "pointnet2part",
            "pointmlppart")
# (fps_cluster, knn_split) launches of one forward, from the code: one FPS
# per PointNet++ stage or PointMLP grouper (4); one k = 3 search per decoder
# level whose queries number 128 or more (ops.knn; the (8, 32) x (8, 8)
# level takes the tiled search, as in geot_tpu): 3 in each part decoder;
# DGCNN's k = 20 and PointMLP's k = 24 searches take the tiled path
_HERITAGE_PER_FORWARD = {"pointnet2cls": (4, 0), "dgcnncls": (0, 0),
                         "pointmlpcls": (4, 0), "pointnet2part": (4, 3),
                         "pointmlppart": (4, 3)}
# the card-vs-CPU float64 step's bounds: the zoo's, by encoder family
_HERITAGE_CMP = {"pointnet2cls": "pointnet2", "dgcnncls": "dgcnn",
                 "pointmlpcls": "pointmlp", "pointnet2part": "pointnet2",
                 "pointmlppart": "pointmlp"}
# the FPS chains: (B, N) and each stage's npoint
_HERITAGE_CHAINS = {"pointnet2cls": (32, 1024, (256, 64, 16, 4)),
                    "pointmlpcls": (32, 1024, (512, 256, 128, 64)),
                    "part": (8, 2048, (512, 128, 32, 8))}


def _heritage_path(name):
    task = "scanobjectnn" if name.endswith("cls") else "shapenetpart"
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfgs",
                        task, f"{name}.yaml")


def _kernels_heritage(bound: Bound):
    """Kernels 1 and 2 at the heritage tasks' shapes: the three FPS chains
    ((32, 1024) for classification, (8, 2048) for part segmentation), the
    part decoders' k = 3 searches ((8, 32) x (8, 8) up to (8, 2048) x (8,
    512)) and a support with duplicates; clouds with fewer points than
    their cluster has blocks, so that blocks own no point (10 and 17
    points on 16 blocks); 40 distinct points sampled to 1024. Each call
    bit-equal to its plain version and timed kernel-only."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops

    dev = torch.device("cuda")
    recs = {}
    for key, (B, N, npoints) in _HERITAGE_CHAINS.items():
        xyz = torch.from_numpy(np.random.default_rng(17).standard_normal(
            (B, N, 3)).astype(np.float32)).to(dev)
        recs[key], levels = _zoo_chain(bound, xyz, npoints)
        if key == "part":
            recs["knn_decoder"] = _zoo_decoders(bound, levels, dup=torch.cat(
                [levels[2], levels[2][:, :64]], dim=1).contiguous())
    chain = {k: sum(recs[c][k] for c in _HERITAGE_CHAINS)
             for k in ("ms", "plain_ms", "bound_ms")}
    chain.update(max_abs_err=0.0, calls={
        f"{c}:{label}": v for c in _HERITAGE_CHAINS
        for label, v in recs[c]["calls"].items()},
        bound_by=recs["part"]["bound_by"])
    for N, npoint in ((10, 4), (17, 8)):
        plan = ops.fps_plan(N, 16)
        empty = sum(1 for lo, hi in plan.ranges(N) if hi <= lo)
        check(empty > 0, f"fps_plan({N}, 16) leaves no block empty: {plan}")
        x = torch.from_numpy(np.random.default_rng(N).standard_normal(
            (32, N, 3)).astype(np.float32)).to(dev)
        got = ops.fps_cluster(x, npoint, plan)
        check(torch.equal(got, ops.fps_ref(x, npoint)),
              f"fps_cluster {N} points on {plan}: differs from fps_ref")
        log(f"fps_cluster (32,{N})->{npoint} on {plan.C} blocks of "
            f"{plan.per_cta}, {empty} of them empty: bit-equal to fps_ref")
    few = torch.from_numpy(np.random.default_rng(40).standard_normal(
        (32, 40, 3)).astype(np.float32))[:, np.random.default_rng(
            41).choice(40, 1024)].contiguous().to(dev)
    got = ops.fps(few, 256)
    check(torch.equal(got, ops.fps_ref(few, 256)),
          "fps on 40 distinct points sampled to 1024: differs")
    zeros = int((got[:, 1:] == 0).sum())
    check(zeros >= 32 * (256 - 40), f"fps on 40 distinct points repeats "
          f"index 0 only {zeros} times")
    log(f"fps (32,1024)->256 on 40 distinct points: bit-equal ({zeros} "
        f"repeats of index 0); the three chains: kernel {chain['ms']:.4f} "
        f"ms, plain {chain['plain_ms']:.1f} ms, bound "
        f"{chain['bound_ms']:.5f} ms; the decoders' 4 searches: kernel "
        f"{recs['knn_decoder']['ms']:.4f} ms, bound "
        f"{recs['knn_decoder']['bound_ms']:.5f} ms")
    return {"fps_chains": chain, "knn_decoder": recs["knn_decoder"]}


def _heritage_batches(cfg, n, dev):
    """``n`` training batches of the config's loader on ``dev`` (from as
    many epochs as it takes) and the batch function of its task."""
    from geot_tpu_torch.data.build import build_dataloader_from_cfg
    from geot_tpu_torch.engine import cls as cls_mod
    from geot_tpu_torch.engine import partseg as partseg_mod

    fn = (cls_mod if cfg.task == "cls" else partseg_mod)._batch
    loader = build_dataloader_from_cfg(
        int(cfg.batch_size), cfg.dataset, cfg.get("datatransforms"),
        split=cfg.dataset.get("train_split", "train"),
        seed=int(cfg.seed), dataloader_cfg=cfg.get("dataloader"),
        is_train=True, device=dev)
    out, epoch = [], 0
    while len(out) < n:
        epoch += 1
        loader.set_epoch(epoch)
        out += [b for b, _ in zip(loader, range(n - len(out)))]
    return out, fn, len(loader)


def _heritage_card_vs_cpu(name, batch_np, batch_fn, lr, dev):
    """One supervised step of the config on 2 clouds in float64 around the
    float32 kernels, dropout off, on the card and on the CPU: loss and
    per-tensor gradients (AdamW's first moment) within the zoo's
    ``_ZOO_CMP_TOL`` of the encoder's family."""
    import torch

    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step

    opts = ([] if name == "pointmlppart"
            else ["model.cls_args.dropout_ratio=0.0"])
    cfg = _zoo_cfg_at(_heritage_path(name), "seed=0", *opts)
    two = {k: v[:2] for k, v in batch_np.items()}
    res = {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        st = TrainState.create(cfg, cfg.model, seed=1, device=d)
        st.model.double()
        if name == "pointmlppart":
            st.model.dropout.rate = 0.0
        b = {k: (v.double() if v.is_floating_point() else v)
             for k, v in batch_fn(two, d).items()}
        t = time.perf_counter()
        loss = float(make_supervised_step(cfg)(st, b, lr)["loss"])
        res[where] = (loss, {n: st.opt.state[p]["exp_avg"].detach().cpu()
                             for n, p in st.model.named_parameters()},
                      time.perf_counter() - t)
    (lg, gg, sg), (lc, gc, sc) = res["card"], res["cpu"]
    rel = abs(lg - lc) / abs(lc)
    gmax = max(float(v.abs().max()) for v in gc.values())
    errs = {k: float((gg[k] - ref).abs().max())
            / max(float(ref.abs().max()), 1e-6 * gmax)
            for k, ref in gc.items()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    loss_tol, grad_tol = _ZOO_CMP_TOL[_HERITAGE_CMP[name]]
    log(f"{name} card vs CPU float64 step (2 clouds; card {sg:.1f} s, CPU "
        f"{sc:.1f} s): loss relative {rel:.2e} (bound {loss_tol}); worst "
        f"per-tensor gradient {worst[0]} {worst[1]:.2e} (bound {grad_tol})")
    check(rel <= loss_tol, f"{name} card vs CPU loss differs: {rel}")
    check(worst[1] <= grad_tol, f"{name} card vs CPU gradients: {worst}")
    return {"loss_rel": rel, "grad_rel": worst[1]}


def _heritage_model(name, dev="cuda"):
    """One heritage config at its published width and batch: 1 warm and 2
    timed supervised steps (launches, peak memory), the float64 step card
    vs CPU, then ``parse_and_run`` for 1 epoch with validation and
    checkpoints and ``mode=test`` on its best checkpoint (the same
    metrics); ``pointnet2part`` once more with ``eval_refine`` and
    ``eval_category_mask``."""
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    dev = torch.device(dev)
    cfg = _zoo_cfg_at(_heritage_path(name), "seed=0")
    f, k = _HERITAGE_PER_FORWARD[name]
    t = time.perf_counter()
    state = TrainState.create(cfg, cfg.model, seed=0, device=dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    batches, batch_fn, steps = _heritage_batches(cfg, 3, dev)
    B, N = batches[0]["pos"].shape[:2]
    log(f"{name}: {cfg.model.NAME}, {n_params} parameters, batch {B} x {N} "
        f"points; built in {time.perf_counter() - t:.1f} s")
    step = make_supervised_step(cfg)
    lr = build_scheduler_from_cfg(cfg)(1)
    want = _launch_counts(fps_cluster=f, knn_split=k)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step_ms = []
    for n, b in enumerate(batches):
        b = batch_fn(b, dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        m = step(state, b, lr)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        got = dict(ops.LAUNCHES)
        check(math.isfinite(float(m["loss"])), f"{name} step {n}: loss "
              f"{float(m['loss'])}")
        check(got == want, f"{name} step {n}: launches {got}, expected "
              f"{want}")
        for key, v in got.items():
            launches[key] += v
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
    log(f"{name}: steps {', '.join(f'{x:.1f}' for x in step_ms)} ms (the "
        f"first warm); loss {float(m['loss']):.6f}; launches a step {want}; "
        f"peak memory {peak_mb:.0f} MiB above the resident "
        f"{resident / 2 ** 20:.0f} MiB")
    del state
    torch.cuda.empty_cache()
    compare = _heritage_card_vs_cpu(name, batches[0], batch_fn, lr, dev)

    primary = "oa" if cfg.task == "cls" else "ins_miou"
    root = tempfile.mkdtemp(prefix=f"geot_heritage_{name}_")
    try:
        common = [f"root_dir={root}", f"device={dev.type}", "seed=0"]
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = train_mod.parse_and_run(["--cfg", _heritage_path(name),
                                       "epochs=1", "save_freq=1", *common])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        run_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        got = dict(ops.LAUNCHES)
        val_batches = 2 if cfg.task == "cls" else 4
        want_run = _launch_counts(fps_cluster=(steps + val_batches) * f,
                                  knn_split=(steps + val_batches) * k)
        check(got == want_run, f"{name} trainer launches {got}, expected "
              f"{want_run} ({steps} steps, {val_batches} val batches)")
        best = res["best"]
        check(math.isfinite(best[primary]) and 0 <= best[primary] <= 100,
              f"{name} trainer: best {best}")
        task = os.path.basename(os.path.dirname(_heritage_path(name)))
        (run_dir,) = [os.path.join(root, task, d)
                      for d in os.listdir(os.path.join(root, task))]
        with open(os.path.join(run_dir, "scalars.jsonl")) as fh:
            sc = {d["tag"]: d["value"] for d in map(json.loads, fh)}
        check(math.isfinite(sc["train/loss"]), f"{name}: train/loss")
        ck = os.path.join(run_dir, "checkpoint")
        for tag in ("latest", "best", "E1"):
            check(os.path.exists(ckpt_path(ck, os.path.basename(run_dir),
                                           tag)), f"{name}: no {tag}")
        best_ck = ckpt_path(ck, os.path.basename(run_dir), "best")
        ops.reset_launches()
        t = time.perf_counter()
        res_t = train_mod.parse_and_run(["--cfg", _heritage_path(name),
                                         "mode=test",
                                         f"pretrained_path={best_ck}",
                                         *common])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t
        got_t = dict(ops.LAUNCHES)
        want_t = _launch_counts(fps_cluster=val_batches * f,
                                knn_split=val_batches * k)
        check(got_t == want_t, f"{name} mode=test launches {got_t}, "
              f"expected {want_t}")
        diff = max(abs(res_t[key] - best[key]) for key in
                   (("oa", "macc") if cfg.task == "cls"
                    else ("ins_miou", "cls_miou")))
        check(diff <= 1e-9, f"{name}: mode=test gives {res_t}, the run's "
              f"validation {best}")
        for key in launches:
            launches[key] += got[key] + got_t[key]
        refined = None
        if name == "pointnet2part":
            ops.reset_launches()
            refined = train_mod.parse_and_run([
                "--cfg", _heritage_path(name), "mode=test",
                f"pretrained_path={best_ck}", "eval_refine=True",
                "eval_category_mask=True", *common])
            got_r = dict(ops.LAUNCHES)
            check(got_r == want_t, f"{name} refined mode=test launches "
                  f"{got_r}, expected {want_t}")
            check(all(math.isfinite(refined[x]) and 0 <= refined[x] <= 100
                      for x in ("ins_miou", "cls_miou")),
                  f"{name} refined: {refined}")
            log(f"{name} mode=test with eval_refine and eval_category_mask: "
                f"ins_miou {refined['ins_miou']:.4f}, cls_miou "
                f"{refined['cls_miou']:.4f} (plain {res_t['ins_miou']:.4f}, "
                f"{res_t['cls_miou']:.4f}); launches {got_r}")
            for key in launches:
                launches[key] += got_r[key]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"{name} trainer: {run_s:.1f} s for 1 epoch of {steps} steps and "
        f"{val_batches} val batches, epoch {sc['epoch_seconds']:.2f} s; "
        f"peak memory {run_peak:.0f} MiB; val {primary} {best[primary]:.4f}; "
        f"mode=test {test_s:.1f} s, {primary} {res_t[primary]:.4f}; "
        f"launches {got} + {got_t}")
    return {"params": n_params, "step_ms": step_ms, "peak_mb": peak_mb,
            "compare": compare, "epoch_seconds": sc["epoch_seconds"],
            "run_s": run_s, "run_peak_mb": run_peak, "test_s": test_s,
            "best": {k_: best[k_] for k_ in best if k_ != "per_category"},
            "refined": refined and {k_: refined[k_] for k_ in
                                    ("ins_miou", "cls_miou")},
            "launches": launches}


def _write_partnormal_tree(root, sizes=(2500, 2700, 2900)):
    """A ShapeNetPartNormal txt tree: airplane, bag and cap, 6 shapes each
    (x y z nx ny nz part; 3 train, 1 val, 2 test) of 2,500 to 2,900
    points, as the public distribution lays it out."""
    import numpy as np

    from geot_tpu_torch.data.shapenetpart import SHAPENETPART_CLS2PARTS

    rng = np.random.default_rng(170)
    cats = (("Airplane", "02691156"), ("Bag", "02773838"),
            ("Cap", "02954340"))
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as fh:
        fh.writelines(f"{n}\t{s}\n" for n, s in cats)
    splits = {"train": [], "val": [], "test": []}
    for c, (_, syn) in enumerate(cats):
        os.makedirs(os.path.join(root, syn), exist_ok=True)
        for i in range(6):
            sid = f"{c}{i:04d}h"
            n = sizes[i % len(sizes)]
            rows = np.concatenate([rng.standard_normal((n, 6)).round(6),
                                   rng.choice(SHAPENETPART_CLS2PARTS[c],
                                              (n, 1))], axis=1)
            np.savetxt(os.path.join(root, syn, sid + ".txt"), rows,
                       fmt="%.6f")
            split = "train" if i < 3 else "val" if i == 3 else "test"
            splits[split].append(f"shape_data/{syn}/{sid}")
    for s, ids in splits.items():
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{s}_file_list.json"), "w") as fh:
            json.dump(ids, fh)


def _heritage_presample():
    """A ShapeNetPartNormal txt tree in a temporary directory: ``presample``
    on the card (one ``fps_cluster`` launch a test shape; the cached rows
    are each shape's at ``fps_ref``'s indices), then ``pointnet2part.yaml``
    at its width on the tree for 1 epoch, reading the cache."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.data.shapenetpart import ShapeNetPartNormal
    from geot_tpu_torch.engine import train as train_mod

    root = tempfile.mkdtemp(prefix="geot_partnormal_")
    try:
        tree = os.path.join(root, "tree")
        _write_partnormal_tree(tree)
        ops.reset_launches()
        t = time.perf_counter()
        ds = ShapeNetPartNormal(data_root=tree, num_points=2048,
                                split="test", presample=True, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        check(got == _launch_counts(fps_cluster=len(ds)),
              f"presample launches {got}, expected {len(ds)} fps_cluster")
        pkl = os.path.join(tree, "processed", "test_2048_fps.pkl")
        with open(pkl, "rb") as fh:
            pre_data, _ = pickle.load(fh)
        for (_, path), rows in zip(ds.items, pre_data):
            raw = np.loadtxt(path).astype(np.float32)
            idx = ops.fps_ref(torch.from_numpy(raw[None, :, :3]), 2048)[0]
            check(np.array_equal(rows, raw[idx.numpy()]),
                  f"presample of {path}: rows differ from fps_ref's")
        log(f"ShapeNetPartNormal presample on the card: {len(ds)} shapes of "
            f"2,500-2,900 points -> 2048 in {secs:.2f} s, rows bit-equal "
            f"to fps_ref's; launches {got}")
        ops.reset_launches()
        t = time.perf_counter()
        res = train_mod.parse_and_run([
            "--cfg", _heritage_path("pointnet2part"), "epochs=1",
            f"dataset.common.data_root={tree}", f"root_dir={root}",
            "device=cuda", "seed=0"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        got_r = dict(ops.LAUNCHES)
        # 12 trainval shapes: 1 step of 8; 6 test shapes: one batch
        f, k = _HERITAGE_PER_FORWARD["pointnet2part"]
        check(got_r == _launch_counts(fps_cluster=2 * f, knn_split=2 * k),
              f"the trainer on the tree: launches {got_r}")
        check(math.isfinite(res["best"]["ins_miou"]),
              f"the trainer on the tree: {res['best']}")
        log(f"pointnet2part on the tree: {run_s:.1f} s for 1 step and 1 "
            f"val batch (the cache read); ins_miou "
            f"{res['best']['ins_miou']:.4f}; launches {got_r}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"seconds": secs, "shapes": len(ds),
            "launches": {k_: got[k_] + got_r[k_] for k_ in got}}


def phase_heritage(bound: Bound):
    """Phase 17: kernels 1 and 2 at the heritage tasks' shapes, then each
    config of ``cfgs/scanobjectnn`` and ``cfgs/shapenetpart`` through its
    steps, the card-vs-CPU step and the trainer, and a txt tree with
    ``presample`` on the card."""
    import collections
    import importlib

    from geot_tpu_torch import ops

    t_phase = time.perf_counter()
    log("phase 17: the heritage tasks (cfgs/scanobjectnn, "
        "cfgs/shapenetpart) at full width")
    recs = _kernels_heritage(bound)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    models = {}
    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    knn_mod = importlib.import_module("geot_tpu_torch.ops.knn")
    real_fps, real_knn = fps_mod.fps_cluster, knn_mod.knn_small_k
    shapes = collections.Counter()

    def fps_counted(xyz, npoint, plan):
        shapes[("fps", xyz.shape[0], xyz.shape[1], npoint)] += 1
        return real_fps(xyz, npoint, plan)

    def knn_counted(q, s_, k):
        shapes[("knn", q.shape[0], q.shape[1], s_.shape[1], k)] += 1
        return real_knn(q, s_, k)

    fps_mod.fps_cluster, knn_mod.knn_small_k = fps_counted, knn_counted
    try:
        for name in HERITAGE:
            models[name] = _heritage_model(name)
            for key, v in models[name]["launches"].items():
                launches[key] += v
        presample = _heritage_presample()
        for key, v in presample["launches"].items():
            launches[key] += v
    finally:
        fps_mod.fps_cluster, knn_mod.knn_small_k = real_fps, real_knn
    chain_calls = [(B, N, m) for B, N0, ms in _HERITAGE_CHAINS.values()
                   for N, m in zip((N0,) + ms[:-1], ms)]
    by_shape = {
        "fps_chains": {f"({B},{N})->{m}": shapes[("fps", B, N, m)]
                       for B, N, m in chain_calls},
        "knn_decoder": {f"(8,{q})x(8,{s_})": shapes[("knn", 8, q, s_, 3)]
                        for q, s_ in ((32, 8), (128, 32), (512, 128),
                                      (2048, 512))}}
    seconds = time.perf_counter() - t_phase
    log(f"heritage launches at the chain and decoder shapes: {by_shape}")
    log("heritage step ms (2 timed): " + "; ".join(
        f"{n} {m['step_ms'][1]:.1f} / {m['step_ms'][2]:.1f}"
        for n, m in models.items()) + "; peak MiB: " + "; ".join(
        f"{n} {m['peak_mb']:.0f}" for n, m in models.items()))
    log(f"phase 17: {seconds:.1f} s; launches {launches}")
    return {"kernels": recs, "models": models, "presample": presample,
            "launches": launches, "launches_by_shape": by_shape,
            "seconds": seconds}


# phase 18: the rest of the model registry. The seg variants of the
# flagship backbone under WholePartSeg_ntm (supervised, cfgs/tooth_sup/
# transformer.yaml), the semi recipe with WholePartSeg_ntm as student and
# teacher, BaseCls over the cls-token PointTransformerEncoder on
# cfgs/scanobjectnn at geot_tpu's defaults, and one forward of each other
# new name card vs CPU
REG_VARIANTS = ("cluster", "classifier", "2classifier")
_REG_FEAT = {"cluster": 64, "classifier": 128, "2classifier": 384}
_REG_NTM = ("model.NAME=WholePartSeg_ntm", "model_t.NAME=WholePartSeg_ntm")
# the cls-token encoder at geot_tpu's defaults (transformer.py:556-572)
# and a ClsHead on its 768 channels
_REG_CLS_MODEL = {"NAME": "BaseCls",
                  "encoder_args": {"NAME": "PointTransformerEncoder"},
                  "cls_args": {"NAME": "ClsHead", "num_classes": 15}}
# card vs CPU of a float32 forward at the tests' small sizes
_REG_FWD_TOL = 1e-4
# the float64 card-vs-CPU steps: one supervised step of a seg variant (the
# supervised loss reads the logits alone, so the three variants' steps are
# the same computation but for the cluster head's zero gradients; the
# cluster variant has the most weights), and one semi step with the
# default criterion, which reads no T-revision output, so that
# WholePartSeg_ntm's step is the flagship's and phase 6's float64 CPU step
# is its reference
_REG_SUP_CMP = "cluster"


def _reg_sup_cfg(variant, *opts):
    return _zoo_cfg("transformer", "model.NAME=WholePartSeg_ntm",
                    "model.segmentor_args.NAME=PointTransformer_seg_"
                    + variant, *opts)


def _reg_semi_cfg(criterion_u=None, **over):
    """The flagship semi recipe with WholePartSeg_ntm as student and
    teacher: the YAML's settings (``FLAGSHIP_SEMI_CFG`` is the YAML,
    ``tests/test_torch_train.py``), which the trainer's gate takes."""
    from geot_tpu_torch import FLAGSHIP_SEMI_CFG
    from geot_tpu_torch.engine import train as train_mod

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfgs",
                        "tooth_semi", "transformer_finetune_fixmatch_ntm.yaml")
    yaml_cfg = _zoo_cfg_at(path, *_REG_NTM, *(
        [f"criterion_u_args.NAME={criterion_u}"] if criterion_u else []))
    train_mod.refuse_unported(yaml_cfg)
    cfg = dict(FLAGSHIP_SEMI_CFG, **over)
    if criterion_u:
        cfg["criterion_u_args"] = dict(cfg["criterion_u_args"],
                                       NAME=criterion_u)
    return cfg


def _reg_sup_step64(variant, batch_np, lr, dev):
    """One float64 supervised step of the variant on the batch's first 2
    clouds on ``dev`` (stochastic depth and dropout off): (loss, name ->
    the first AdamW moment on the host, seconds)."""
    import torch

    from geot_tpu_torch.data.build import MODEL_KEYS, to_device
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step

    cfg = _reg_sup_cfg(variant, *_ZOO_NO_DROPOUT["transformer"])
    two = {k: v[:2] for k, v in batch_np.items()}
    st = TrainState.create(cfg, cfg.model, seed=1, device=dev)
    st.model.double()
    b = {k: (v.double() if v.is_floating_point() else v)
         for k, v in to_device(two, MODEL_KEYS, dev).items()}
    t = time.perf_counter()
    m = make_supervised_step(cfg)(st, b, lr)
    loss = float(m["loss"])
    return loss, {n: st.opt.state[p]["exp_avg"].detach().cpu()
                  for n, p in st.model.named_parameters()}, \
        time.perf_counter() - t


def _reg_semi_step64(cm, lr, dev, criterion_u=None,
                     model_name="WholePartSeg_ntm"):
    """One float64 semi step of the recipe with ``model_name`` as student
    and teacher on 1 + 1 + 1 clouds on ``dev``, ``CMP_TRUNK``, as phase
    6's: (loss terms, name -> first moment, ema_t, seconds)."""
    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS
    from geot_tpu_torch.data.build import (MODEL_KEYS, SEMI_KEYS,
                                           build_semi_loaders, semi_pairs,
                                           to_device)
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    cfg = _reg_semi_cfg(criterion_u, batch_size_l=1, batch_size_u=1)
    seg = dict(FLAGSHIP_SEG_ARGS, **CMP_TRUNK)
    l1, u1 = build_semi_loaders(cfg)
    for loader in (l1, u1):
        loader.set_epoch(1)
    bl, bu = next(semi_pairs(l1, u1, limit=1))
    st = SemiTrainState.create(cfg, seg_args=seg, seed=1, device=dev,
                               model_name=model_name)
    for mod in (st.model, st.teacher, st.t_predictor):
        mod.double()
    st.ema_t = st.ema_t.double()
    st.cm = cm.to(dev, torch.float64)
    batches = [{k: (v.double() if v.is_floating_point() else v)
                for k, v in to_device(b, keys, dev).items()}
               for b, keys in ((bl, MODEL_KEYS), (bu, SEMI_KEYS))]
    t = time.perf_counter()
    m = make_semi_step(cfg)(st, *batches, lr, True)
    terms = {k: float(m[k]) for k in ("loss", "sup_loss", "unsup_loss",
                                      "threed_loss")}
    return terms, _adam_grads(st), st.ema_t.double().cpu(), \
        time.perf_counter() - t


def _reg_grad_err(gg, gc):
    """The worst per-tensor max |d| / max |g| (scale floored at 1e-6 of the
    largest gradient, as phase 12's)."""
    gmax = max(float(v.abs().max()) for v in gc.values())
    errs = {k: float((gg[k].double() - ref.double()).abs().max())
            / max(float(ref.abs().max()), 1e-6 * gmax)
            for k, ref in gc.items()}
    return max(errs.items(), key=lambda kv: kv[1])


def _reg_small_models():
    """The other new names at the tests' small sizes: name -> (model
    config, inputs)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(18)
    pos = torch.from_numpy(rng.uniform(-1, 1, (2, 128, 3)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 128, 3)).astype(
        np.float32))
    f16 = torch.from_numpy(rng.standard_normal((2, 128, 16)).astype(
        np.float32))
    probs = torch.softmax(torch.from_numpy(rng.standard_normal(
        (2, 16, 17)).astype(np.float32)), -1)
    enc = {"NAME": "PointNet2Encoder", "in_channels": 3, "width": 8,
           "layers": 2, "strides": [4, 4], "radius": 0.2, "num_samples": 8,
           "blocks": [1, 1], "aggr_args": {"feature_type": "dp_fj"}}
    head = {"NAME": "VariableSegHead", "num_classes": 17, "in_channels": 24}
    return {
        "PointTransformerGenEncoder": (
            {"NAME": "PointTransformerGenEncoder", "num_groups": 16,
             "group_size": 8, "encoder_dims": 32, "trans_dim": 48,
             "depth": 2, "num_heads": 4, "radius": 0.4}, (pos,)),
        "PointPatchEmbed": ({"NAME": "PointPatchEmbed", "sample_ratio": 0.25,
                             "group_size": 8, "channels": [16, 32],
                             "in_channels": 3}, (pos, x)),
        "P3Embed": ({"NAME": "P3Embed", "stages": 2, "sample_ratio": 0.5,
                     "group_size": 8, "channels": [8, 16]}, (pos,)),
        "VariableSeg": ({"NAME": "VariableSeg", "encoder_args": enc,
                         "decoder_args": {"NAME": "PointNet2Decoder"},
                         "cls_args": head}, (pos, x)),
        "DistillBaseSeg": ({"NAME": "DistillBaseSeg", "encoder_args": enc,
                            "decoder_args": {"NAME": "PointNet2Decoder"},
                            "cls_args": head, "distill_args": {}},
                           (pos, x)),
        "MultiSegHead": ({"NAME": "MultiSegHead", "in_channels": 16,
                          "shape_classes": 4, "num_parts": [2, 3, 4, 2]},
                         (f16,)),
        "Ins_T": ({"NAME": "Ins_T", "T_args": {"NAME": "sig_t",
                                               "nclasses": 17}}, (probs,)),
    }


def _reg_forwards():
    """Phase 18 (d): one eval forward of each other new name on the card
    against the CPU from the same seeded weights; ``Gragh_Matching`` must
    raise. Returns name -> max |d| / max |out| and the launches."""
    import copy

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.core.config import build_model_from_cfg
    from geot_tpu_torch.models.segmentation.base_seg import init_weights

    out, launches = {}, dict.fromkeys(ops.LAUNCHES, 0)
    for name, (cfg, args) in _reg_small_models().items():
        model = init_weights(build_model_from_cfg(cfg),
                             torch.Generator().manual_seed(18)).eval()
        card = copy.deepcopy(model).cuda()
        ops.reset_launches()
        with torch.no_grad():
            want = model(*args)
            got = card(*(a.cuda() for a in args))
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        rel = max(float((g.cpu() - w).abs().max())
                  / max(float(w.abs().max()), 1e-30)
                  for g, w in zip(got, want))
        check(all(g.shape == w.shape for g, w in zip(got, want)),
              f"{name}: card shapes differ from the CPU's")
        check(rel <= _REG_FWD_TOL, f"{name} card vs CPU forward: {rel}")
        out[name] = rel
    gm = build_model_from_cfg({"NAME": "Gragh_Matching"}).cuda()
    try:
        gm(torch.zeros(1, device="cuda"), None, None)
    except NotImplementedError:
        out["Gragh_Matching"] = "raises NotImplementedError"
    else:
        check(False, "Gragh_Matching did not raise")
    log("phase 18 (d) card vs CPU forwards, max |d| / max |out|: "
        + ", ".join(f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in out.items()) + f"; launches {launches}")
    return out, launches


def _reg_inputs():
    """Phase 18's inputs: 3 batches of ``transformer.yaml``'s loader (4 x
    16,000 points), epoch 1's learning rate, a class-mean matrix and a
    served scan with its 16,000-point sample."""
    import numpy as np
    import torch

    from geot_tpu_torch.data.build import build_dataloader_from_cfg
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    cfg = _reg_sup_cfg("cluster")
    loader = build_dataloader_from_cfg(int(cfg.batch_size_l), cfg.dataset_l,
                                       cfg.datatransforms, split="train",
                                       seed=int(cfg.seed))
    loader.set_epoch(1)
    it = iter(loader)
    batches_np = [next(it) for _ in range(3)]
    rng = np.random.default_rng(18)
    cm = torch.from_numpy(rng.dirichlet(np.ones(17), 17).astype(np.float32))
    pts, sample, _, _ = _scan_sample(18)
    return (batches_np, build_scheduler_from_cfg(cfg)(1), cm, pts,
            torch.from_numpy(sample)[None])


def _reg_variant(variant, batches_np, lr, dev):
    """Phase 18 (a) on the card: the variant's 1 warm and 2 timed steps at
    the YAML's batch, launches and peak memory, and for ``_REG_SUP_CMP``
    its float64 step."""
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.data.build import MODEL_KEYS, to_device
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step

    cfg = _reg_sup_cfg(variant)
    f, k = _ZOO_PER_FORWARD["transformer"]
    state = TrainState.create(cfg, cfg.model, seed=0, device=dev)
    step = make_supervised_step(cfg)
    want = _launch_counts(fps_cluster=f, knn_split=k)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step_ms = []
    for n, b in enumerate(batches_np):
        b = to_device(b, MODEL_KEYS, dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        m = step(state, b, lr)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        got = dict(ops.LAUNCHES)
        check(math.isfinite(float(m["loss"])), f"{variant} step {n}: loss "
              f"{float(m['loss'])}")
        check(got == want, f"{variant} step {n}: launches {got}, expected "
              f"{want}")
        for key, v in got.items():
            launches[key] += v
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
    with torch.no_grad():
        out = state.model.eval()(to_device(batches_np[0], MODEL_KEYS, dev))
    check(out[3].shape[-1] == _REG_FEAT[variant] and out[1] is None
          and out[2] is None, f"{variant}: outputs {[type(o) for o in out]}")
    del state, out
    torch.cuda.empty_cache()
    card64 = None
    if variant == _REG_SUP_CMP:
        ops.reset_launches()
        card64 = _reg_sup_step64(variant, batches_np[0], lr, dev)
        for key, v in ops.LAUNCHES.items():
            launches[key] += v
    log(f"{variant}: WholePartSeg_ntm over PointTransformer_seg_{variant}, "
        f"batch {len(batches_np[0]['pos'])} x "
        f"{batches_np[0]['pos'].shape[1]}; steps "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms (the first warm); "
        f"launches a step {want}; peak {peak_mb:.0f} MiB above the resident "
        f"{resident / 2 ** 20:.0f} MiB")
    return {"step_ms": step_ms, "peak_mb": peak_mb, "launches": launches,
            "card64": card64}


def _reg_semi(cm, lr, dev, ref):
    """Phase 18 (b) on the card: the semi recipe with WholePartSeg_ntm, 3
    steps at 2 + 2 + 2 clouds per criterion (2 FPS and 14 kNN launches a
    step, finite losses), and the float64 step with the default criterion
    from ``ref``'s class means and learning rate (phase 6's)."""
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.data.build import (MODEL_KEYS, SEMI_KEYS,
                                           build_semi_loaders, semi_pairs,
                                           to_device)
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    want = _launch_counts(fps_cluster=2, knn_split=14)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    recs = {}
    for crit in (None, "Poly1FocalLoss_U_T_v1"):
        cfg = _reg_semi_cfg(crit)
        state = SemiTrainState.create(cfg, seed=0, device=dev,
                                      model_name="WholePartSeg_ntm")
        check(type(state.teacher).__name__ == "WholePartSegNTM",
              "the teacher is not WholePartSeg_ntm")
        state.cm = cm.to(dev)
        loader_l, loader_u = build_semi_loaders(cfg)
        for loader in (loader_l, loader_u):
            loader.set_epoch(1)
        step = make_semi_step(cfg)
        step_ms, losses = [], []
        for n, (bl, bu) in enumerate(semi_pairs(loader_l, loader_u,
                                                limit=3)):
            bl = to_device(bl, MODEL_KEYS, dev)
            bu = to_device(bu, SEMI_KEYS, dev)
            torch.cuda.synchronize()
            ops.reset_launches()
            t = time.perf_counter()
            m = step(state, bl, bu, lr, True)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            got = dict(ops.LAUNCHES)
            terms = {k: float(m[k]) for k in ("loss", "sup_loss",
                                              "unsup_loss", "threed_loss")}
            check(all(math.isfinite(v) for v in terms.values()),
                  f"semi ntm {crit} step {n}: {terms}")
            check(got == want, f"semi ntm {crit} step {n}: launches {got}, "
                  f"expected {want}")
            for key, v in got.items():
                launches[key] += v
            losses.append(terms["loss"])
        del state
        torch.cuda.empty_cache()
        label = crit or "Poly1FocalLoss_U_corr (default)"
        log(f"semi WholePartSeg_ntm, {label}: steps "
            f"{', '.join(f'{x:.1f}' for x in step_ms)} ms; losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}; launches a step "
            f"{want}")
        recs[label] = {"step_ms": step_ms, "losses": losses}
    ops.reset_launches()
    card64 = _reg_semi_step64(ref["cm"], ref["lr"], dev)
    for key, v in ops.LAUNCHES.items():
        launches[key] += v
    log(f"semi WholePartSeg_ntm, default criterion: float64 step on the "
        f"card {card64[3]:.1f} s")
    return recs, card64, launches


def _reg_cls(dev):
    """Phase 18 (c): BaseCls over PointTransformerEncoder at geot_tpu's
    defaults on cfgs/scanobjectnn/default.yaml (1024 points, batch 32): 1
    warm and 2 timed steps, then the trainer for 1 epoch from a config this
    function writes to a temporary file, and ``mode=test`` on its best
    checkpoint."""
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.core.config import dump_yaml
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfgs",
                        "scanobjectnn", "default.yaml")
    cfg = _zoo_cfg_at(path, "seed=0")
    cfg.model = json.loads(json.dumps(_REG_CLS_MODEL))
    state = TrainState.create(cfg, cfg.model, seed=0, device=dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    check(state.model.head.mlp_0.in_features == 768,
          f"ClsHead on {state.model.head.mlp_0.in_features} channels")
    batches, batch_fn, steps = _heritage_batches(cfg, 3, dev)
    step = make_supervised_step(cfg)
    lr = build_scheduler_from_cfg(cfg)(1)
    want = _launch_counts(fps_cluster=1, knn_split=0)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for n, b in enumerate(batches):
        b = batch_fn(b, dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        m = step(state, b, lr)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        got = dict(ops.LAUNCHES)
        check(math.isfinite(float(m["loss"])), f"cls-token step {n}")
        check(got == want, f"cls-token step {n}: launches {got}, expected "
              f"{want}")
        for key, v in got.items():
            launches[key] += v
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    B, N = batches[0]["pos"].shape[:2]
    del state
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="geot_cls_token_")
    try:
        cfg_path = os.path.join(root, "cfgs", "cls_token", "encoder.yaml")
        os.makedirs(os.path.dirname(cfg_path))
        with open(cfg_path, "w") as fh:
            fh.write(dump_yaml(cfg.dict()))
        common = [f"root_dir={root}/runs", f"device={dev.type}", "seed=0"]
        ops.reset_launches()
        t = time.perf_counter()
        res = train_mod.parse_and_run(["--cfg", cfg_path, "epochs=1",
                                       "save_freq=1", *common])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        val_batches = 2
        want_run = _launch_counts(fps_cluster=steps + val_batches,
                                  knn_split=0)
        check(got == want_run, f"cls-token trainer launches {got}, "
              f"expected {want_run}")
        best = res["best"]
        check(math.isfinite(best["oa"]) and 0 <= best["oa"] <= 100,
              f"cls-token trainer: best {best}")
        best_ck = [os.path.join(d, x) for d, _, xs in os.walk(root)
                   for x in xs if "best" in x]
        check(len(best_ck) == 1, f"cls-token best checkpoints {best_ck}")
        ops.reset_launches()
        res_t = train_mod.parse_and_run(["--cfg", cfg_path, "mode=test",
                                         f"pretrained_path={best_ck[0]}",
                                         *common])
        torch.cuda.synchronize()
        got_t = dict(ops.LAUNCHES)
        check(got_t == _launch_counts(fps_cluster=val_batches, knn_split=0),
              f"cls-token mode=test launches {got_t}")
        diff = max(abs(res_t[k] - best[k]) for k in ("oa", "macc"))
        check(diff <= 1e-9, f"cls-token mode=test {res_t} vs the run's "
              f"{best}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for key in launches:
        launches[key] += got[key] + got_t[key]
    log(f"cls-token BaseCls over PointTransformerEncoder: {n_params} "
        f"parameters, batch {B} x {N}; steps "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms (the first warm); "
        f"peak {peak_mb:.0f} MiB; trainer {run_s:.1f} s for {steps} steps "
        f"and {val_batches} val batches, oa {best['oa']:.4f}; mode=test oa "
        f"{res_t['oa']:.4f}; launches {launches}")
    return {"params": n_params, "step_ms": step_ms, "peak_mb": peak_mb,
            "run_s": run_s, "oa": best["oa"], "launches": launches}


def phase_registry(bound: Bound, semi_ref=None):
    """Phase 18: kernels 1 and 2 at this slice's shapes, then (a) the seg
    variants, (b) the semi recipe with WholePartSeg_ntm, (c) the cls-token
    encoder, (d) the other new names, and last the CPU sides of (a): the
    float64 step and the served sample's forward. The CPU side of (b)'s
    float64 step is ``semi_ref``, phase 6's float64 CPU step and its
    inputs (computed here without one)."""
    import collections
    import importlib

    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine.predict import load_model, predict_scan

    t_phase = time.perf_counter()
    log("phase 18: the rest of the model registry at full width")
    dev = torch.device("cuda")
    cfg = _reg_sup_cfg("cluster")
    batches_np, lr, cm, pts, scan = _reg_inputs()
    if semi_ref is None:
        terms, grads, ema, _ = _reg_semi_step64(cm, lr, "cpu",
                                                model_name="WholePartSeg")
        semi_ref = {"cpu": (terms, grads, ema), "cm": cm, "lr": lr}

    # kernels 1 and 2 at the slice's shapes, counted by shape over the phase
    x4 = torch.from_numpy(batches_np[0]["pos"]).to(dev).contiguous()
    fps4, levels4 = _zoo_chain(bound, x4, (8192,))
    searches, _, _ = _scan_searches(pts, x4, np.zeros(3, np.float32), 1.0)
    dup = torch.cat([levels4[1][:, :2048], levels4[1][:, :2048]],
                    dim=1).contiguous()
    knn4, _ = _kernels_knn(bound, searches[:7], ("ties", dup, dup, 4))
    x32 = torch.from_numpy(np.random.default_rng(180).standard_normal(
        (32, 1024, 3)).astype(np.float32)).to(dev)
    fps32, _ = _zoo_chain(bound, x32, (256,))
    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    knn_mod = importlib.import_module("geot_tpu_torch.ops.knn")
    real_fps, real_knn = fps_mod.fps_cluster, knn_mod.knn_small_k
    shapes = collections.Counter()

    def fps_counted(xyz, npoint, plan):
        if xyz.is_cuda:
            shapes[("fps", xyz.shape[0], xyz.shape[1], npoint)] += 1
        return real_fps(xyz, npoint, plan)

    def knn_counted(q, s_, k):
        if q.is_cuda:
            shapes[("knn", q.shape[0])] += 1
        return real_knn(q, s_, k)

    launches = dict.fromkeys(ops.LAUNCHES, 0)
    fps_mod.fps_cluster, knn_mod.knn_small_k = fps_counted, knn_counted
    try:
        variants = {}
        for v in REG_VARIANTS:
            variants[v] = _reg_variant(v, batches_np, lr, dev)
            for key, n in variants[v]["launches"].items():
                launches[key] += n
        model = load_model(model_cfg=dict(cfg.model), device=dev)
        ops.reset_launches()
        t = time.perf_counter()
        labels, logits = predict_scan(model, pts, 0)
        torch.cuda.synchronize()
        scan_ms = (time.perf_counter() - t) * 1e3
        check(labels.shape == (len(pts),) and bool(
            torch.isfinite(logits).all()), "cluster predict_scan")
        with torch.no_grad():
            feats = model({"pos": scan.to(dev), "x": scan.to(dev),
                           "cls": torch.zeros(1, 1, dtype=torch.long,
                                              device=dev)})
        torch.cuda.synchronize()
        for key, n in ops.LAUNCHES.items():
            launches[key] += n
        semi, semi64, semi_launches = _reg_semi(cm, lr, dev, semi_ref)
        cls_token = _reg_cls(dev)
        for part in (semi_launches, cls_token["launches"]):
            for key, n in part.items():
                launches[key] += n
    finally:
        fps_mod.fps_cluster, knn_mod.knn_small_k = real_fps, real_knn
    forwards, fwd_launches = _reg_forwards()
    for key, n in fwd_launches.items():
        launches[key] += n

    # card vs CPU: the CPU sides of (a), after the card's work
    t_cpu = time.perf_counter()
    v = _REG_SUP_CMP
    cpu_sup = _reg_sup_step64(v, batches_np[0], lr, "cpu")
    cpu_model = load_model(model_cfg=dict(cfg.model), device="cpu")
    with torch.no_grad():
        t = time.perf_counter()
        want_out = cpu_model({"pos": scan, "x": scan,
                              "cls": torch.zeros(1, 1, dtype=torch.long)})
        cpu_s = time.perf_counter() - t
    del cpu_model
    cpu_seconds = time.perf_counter() - t_cpu
    (lg, gg, sg), (lc, gc, sc) = variants[v]["card64"], cpu_sup
    rel = abs(lg - lc) / abs(lc)
    worst = _reg_grad_err(gg, gc)
    loss_tol, grad_tol = _ZOO_CMP_TOL["transformer"]
    log(f"{v} card vs CPU float64 step (2 clouds; card {sg:.1f} s, CPU "
        f"{sc:.1f} s): loss relative {rel:.2e} (bound {loss_tol}); worst "
        f"per-tensor gradient {worst[0]} {worst[1]:.2e} (bound {grad_tol})")
    check(rel <= loss_tol, f"{v} card vs CPU loss: {rel}")
    check(worst[1] <= grad_tol, f"{v} card vs CPU gradients: {worst}")
    compare = {v: {"loss_rel": rel, "grad_rel": worst[1]}}
    (lg, gg, eg, sg), (lc, gc, ec) = semi64, semi_ref["cpu"]
    rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lg)
    worst = _reg_grad_err({k: v for k, v in gg.items()
                           if k not in _ZERO_GRAD},
                          {k: v for k, v in gc.items()
                           if k not in _ZERO_GRAD})
    ema = float((eg - ec).abs().max())
    log(f"semi WholePartSeg_ntm card vs WholePartSeg CPU float64 step (1 + "
        f"1 + 1, default criterion; card {sg:.1f} s): loss terms relative "
        f"{rel:.2e}; worst per-tensor gradient {worst[0]} {worst[1]:.2e}; "
        f"ema_t {ema:.2e}")
    check(rel <= 1e-4, f"semi card vs CPU losses: {rel}")
    check(worst[1] <= 1e-3, f"semi card vs CPU gradients: {worst}")
    check(ema <= 1e-6, f"semi card vs CPU ema_t: {ema}")
    compare["semi"] = {"loss_rel": rel, "grad_rel": worst[1]}
    f_rel = float((feats[3].cpu() - want_out[3]).abs().max()
                  / want_out[3].abs().max())
    l_rel = float((feats[0].cpu() - want_out[0]).abs().max()
                  / want_out[0].abs().max())
    agree = float((feats[0].cpu().argmax(-1) == want_out[0].argmax(-1))
                  .float().mean())
    log(f"cluster predict_scan: {scan_ms:.1f} ms for a {len(pts)}-point "
        f"scan; its 16,000-point forward card vs CPU ({cpu_s:.1f} s): "
        f"64-d features max |d| / max {f_rel:.2e}, logits {l_rel:.2e}, "
        f"argmax agreement {agree:.5f}")
    check(feats[3].shape == (1, 16000, 64), "cluster features' shape")
    check(f_rel <= 1e-3 and l_rel <= 1e-3 and agree >= 0.999,
          f"cluster card vs CPU: features {f_rel}, logits {l_rel}, argmax "
          f"{agree}")
    compare["predict_cluster"] = {"feat_rel": f_rel, "logit_rel": l_rel,
                                  "argmax": agree}
    by_shape = {"fps_4x16000_8192": shapes[("fps", 4, 16000, 8192)],
                "fps_32x1024_256": shapes[("fps", 32, 1024, 256)],
                "knn_B4": shapes[("knn", 4)]}
    seconds = time.perf_counter() - t_phase
    log("phase 18 step ms (2 timed): " + "; ".join(
        f"{v} {r['step_ms'][1]:.1f} / {r['step_ms'][2]:.1f}"
        for v, r in variants.items()) + "; semi " + "; ".join(
        f"{k} {r['step_ms'][1]:.1f} / {r['step_ms'][2]:.1f}"
        for k, r in semi.items()) + f"; cls-token "
        f"{cls_token['step_ms'][1]:.1f} / {cls_token['step_ms'][2]:.1f}")
    log(f"phase 18: {seconds:.1f} s (the CPU sides {cpu_seconds:.1f} s); "
        f"launches {launches}; at the slice's kernel shapes {by_shape}")
    return {"kernels": {"fps_4x16000": fps4, "knn_4x16000": knn4,
                        "fps_32x1024": fps32},
            "variants": variants, "semi": semi, "cls_token": cls_token,
            "forwards": forwards, "compare": compare, "launches": launches,
            "launches_by_shape": by_shape, "seconds": seconds,
            "cpu_seconds": cpu_seconds}


# phase 19: the reference layer and op API. VoteNet's backbone
# (facebookresearch/votenet models/backbone_module.py: SUN RGB-D with the
# height feature, 20,000 points, batch 8): per SA level npoint, radius,
# nsample and mlp (mlp[0] the input feature width)
VOTENET_SA = ((2048, 0.2, 64, (1, 64, 64, 128)),
              (1024, 0.4, 32, (128, 128, 128, 256)),
              (512, 0.8, 16, (256, 128, 128, 256)),
              (256, 1.2, 16, (256, 128, 128, 256)))
# float64 card vs CPU: the relative bound on every module's output (the
# indices are the same; the sums run in other orders)
REF64_RTOL = 1e-9
# DeepGCN's blocks (arXiv:1904.03751, ResGCN-28's width): clouds x points,
# channels, neighbours
DEEPGCN = (8, 4096, 64, 16)
# DeepGCN's feature search runs in float32 on both devices, where cuBLAS
# and the CPU round the expansion differently: the share of output rows
# that agree to REF64_RTOL must reach this
DEEPGCN_ROWS_AGREE = 0.99


def _votenet_scene(B: int, N: int, seed: int):
    """Synthetic indoor scenes: B clouds of N points in a 6 x 6 x 2 m room
    (floor, walls and boxes), with VoteNet's height feature (z above the
    cloud's 1st percentile)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = np.empty((B, N, 3), np.float32)
    for b in range(B):
        n_floor, n_wall = N // 3, N // 4
        floor = np.c_[rng.uniform(-3, 3, (n_floor, 2)), np.zeros(n_floor)]
        wall = np.c_[rng.uniform(-3, 3, n_wall), np.full(n_wall, 3.0),
                     rng.uniform(0, 2, n_wall)]
        rest = N - n_floor - n_wall
        centres = rng.uniform([-2.5, -2.5, 0.3], [2.5, 2.5, 1.2], (8, 3))
        boxes = centres[rng.integers(0, 8, rest)] + rng.uniform(
            -0.4, 0.4, (rest, 3))
        pts[b] = np.concatenate([floor, wall, boxes]) + rng.normal(
            0, 0.005, (N, 3))
    height = pts[..., 2:] - np.percentile(pts[..., 2], 1, axis=1)[:, None,
                                                                  None]
    return pts, height.astype(np.float32)


def _votenet_backbone(seed: int = 190):
    """The four SA levels of VoteNet's ``Pointnet2Backbone`` over the
    port's ``PointnetSAModuleVotes`` (its FP levels are the zoo's 3-NN
    propagation, driven in phase 12): (xyz, features) -> (SA4's xyz,
    SA4's features, each level's indices)."""
    import torch

    from geot_tpu_torch.models.backbone import PointnetSAModuleVotes

    class Backbone(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.sa = torch.nn.ModuleList(
                PointnetSAModuleVotes(list(mlp), npoint, radius, nsample,
                                      normalize_xyz=True)
                for npoint, radius, nsample, mlp in VOTENET_SA)

        def forward(self, xyz, features):
            inds = []
            for sa in self.sa:
                xyz, features, ind = sa(xyz, features)
                inds.append(ind)
            return (xyz, features, *inds)

    torch.manual_seed(seed)
    return Backbone()


def _card_vs_cpu64(name, module, args, dev):
    """``module``'s float64 eval forward on the card and on the CPU from the
    same weights and inputs; the relative difference of every output."""
    import copy

    import torch

    cpu = copy.deepcopy(module).double().eval()
    card = copy.deepcopy(module).double().eval().to(dev)
    with torch.no_grad():
        t = time.perf_counter()
        want = cpu(*(a.double() if a.is_floating_point() else a
                     for a in args))
        cpu_s = time.perf_counter() - t
        got = card(*(a.double().to(dev) if a.is_floating_point()
                     else a.to(dev) for a in args))
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    rel = {}
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or not w.is_floating_point():
            check(g is None and w is None or torch.equal(g.cpu(), w),
                  f"{name}: output {i} (indices) differ card vs CPU")
            continue
        finite = torch.isfinite(w)
        check(torch.equal(torch.isfinite(g.cpu()), finite),
              f"{name}: output {i} finite at other places")
        rel[i] = float((g.cpu()[finite] - w[finite]).abs().max()
                       / w[finite].abs().max())
    return rel, cpu_s


def phase_reference(bound: Bound):
    """Phase 19: (a) the compat ops at the flagship scan's shapes, (b)
    VoteNet's backbone at 20,000 points and batch 8, (c) DeepGCN's blocks,
    ASSA, KMeansEmbed and TransformerEncoder, (d) the native grid
    subsampling of a 150,000-point scan. The main path runs first with the
    launch counts at 0; the kernels' checks against their plain versions
    and their times after it."""
    import copy

    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.models import layers
    from geot_tpu_torch.ops.fps import card_cluster_size
    from geot_tpu_torch.ops.compat import (openpoints_pointops,
                                           pointnet2_utils, pointops)

    t_phase = time.perf_counter()
    log("phase 19: the reference layer and op API")
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    _, x_np, _, _ = _scan_sample(191)
    _, x2_np, _, _ = _scan_sample(192)
    x = torch.from_numpy(np.stack([x_np, x2_np])).to(dev)       # (2, 16000)
    N = x.shape[1]
    new = x[:, ::4].contiguous()                                 # 4000
    rng = np.random.default_rng(193)
    feat = torch.from_numpy(rng.standard_normal((2, N, 64)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (2, N)).astype(
        np.float32)).to(dev)
    scene, height = _votenet_scene(8, 20000, 194)
    scene_t = torch.from_numpy(scene).to(dev)
    height_t = torch.from_numpy(height).to(dev)
    backbone = _votenet_backbone().to(dev).train()
    gB, gN, gC, gk = DEEPGCN
    gcn = torch.nn.Sequential(*(layers.ResDynBlock(gC, "edge", k=gk)
                                for _ in range(2))).to(dev).train()
    gcn_x = torch.randn(gB, gN, gC, generator=torch.Generator().manual_seed(
        195)).to(dev)

    def compat():
        """The compat calls at the scan's shapes: 2 FPS and 3 small-k
        searches on the kernels, the rest plain PyTorch."""
        out = {}
        out["i3"], out["d3"] = pointops.knn(x, x, 3)
        out["i16"], _ = pointops.knn(new, x, 16)
        out["sampled"] = pointops.fps(x, 512)
        out["inds"] = pointnet2_utils.furthest_point_sample(x, 512)
        out["sampled_w"] = pointops.fps_weight(x, 512, w)
        out["qg"] = openpoints_pointops.queryandgroup(32, x, out["sampled"],
                                                      feat)
        out["gx"], out["gf"] = openpoints_pointops.querygroup(
            32, x, out["sampled"], feat, normalize_dp=True)
        out["up3"] = openpoints_pointops.interpolation(new, x, feat[:, ::4],
                                                       k=3)
        out["up6"] = openpoints_pointops.interpolation(new, x, feat[:, ::4],
                                                       k=6)
        out["dist"], out["idx3"] = pointnet2_utils.three_nn(x, new)
        out["sub"] = openpoints_pointops.subtraction(feat[:, ::4], feat,
                                                     out["i16"])
        out["agg"] = openpoints_pointops.aggregation(
            feat, torch.softmax(out["sub"][..., :8], dim=2), out["i16"])
        sync()
        return out

    def grew(before):
        return {k: v - before[k] for k, v in ops.LAUNCHES.items()}

    # --- the main path, counted part by part -----------------------------
    ops.reset_launches()
    sync()
    ms = {}
    t = time.perf_counter()
    c = compat()
    by_part = {"compat": dict(ops.LAUNCHES)}
    # the first calls load the CUDA modules of the kernels they use
    ms["compat_calls_first"] = (time.perf_counter() - t) * 1e3
    i3, d3, i16, sampled, inds, sampled_w, qg, gx, gf, up3, up6, dist, \
        idx3, sub, agg = (c[k] for k in (
            "i3", "d3", "i16", "sampled", "inds", "sampled_w", "qg", "gx",
            "gf", "up3", "up6", "dist", "idx3", "sub", "agg"))
    for name_, out in (("queryandgroup", qg), ("querygroup", gf),
                       ("interpolation k=3", up3), ("interpolation k=6", up6),
                       ("aggregation", agg)):
        check(bool(torch.isfinite(out).all()), f"compat {name_} not finite")
    check(qg.shape == (2, 512, 32, 67) and gx.shape == (2, 512, 32, 3)
          and float(gx.norm(dim=-1).amax()) <= 1.0 + 1e-6,
          "compat grouping shapes / normalize_dp")
    check(agg.shape == (2, N // 4, 64) and sub.shape == (2, N // 4, 16, 64),
          "compat vector attention shapes")
    # VoteNet's SA levels: a warm and 2 timed forward + backward, batch 8
    before = dict(ops.LAUNCHES)
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        out_xyz, out_f, *_ = backbone(scene_t, height_t)
        out_f.square().mean().backward()
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    votenet_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(out_f.shape == (8, 256, 256) and bool(torch.isfinite(out_f).all())
          and all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  for p in backbone.parameters()),
          "VoteNet backbone: output or gradients")
    by_part["votenet"] = grew(before)
    # DeepGCN: 2 ResDynBlocks, a warm and 2 timed forward + backward
    before = dict(ops.LAUNCHES)
    gcn_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        g = gcn(gcn_x)
        g.square().mean().backward()
        sync()
        gcn_ms.append((time.perf_counter() - t0) * 1e3)
    gcn_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(bool(torch.isfinite(g).all()), "DeepGCN output")
    by_part["deepgcn"] = grew(before)
    launches = dict(ops.LAUNCHES)
    t = time.perf_counter()
    compat()
    ms["compat_calls"] = (time.perf_counter() - t) * 1e3
    plan8 = ops.fps_plan(scene.shape[1], card_cluster_size(dev, 8))
    log(f"VoteNet SA1's FPS {tuple(scene.shape[:2])} -> 2048: plan "
        f"{plan8}")
    # compat: 2 FPS and 3 small-k searches; VoteNet: 4 SA levels x 3
    # passes, each one FPS; DeepGCN's feature searches: int64 topk
    want = {"compat": _launch_counts(fps_cluster=2, knn_split=3),
            "votenet": _launch_counts(fps_cluster=12),
            "deepgcn": _launch_counts()}
    for part, counts in want.items():
        check(by_part[part] == counts, f"phase 19 {part} launches "
              f"{by_part[part]}, expected {counts}")

    # --- kernels 1 and 2 against their plain versions, kernel-only times ---
    d_r, i_r = ops.knn_small_k_ref(x, x, 3)
    check(torch.equal(i3, i_r) and torch.equal(d3, d_r),
          "pointops.knn k=3 differs from knn_small_k_ref")
    d_r, i_r = ops.knn_small_k_ref(x, new, 3)
    check(torch.equal(idx3, i_r) and torch.equal(dist, d_r.sqrt()),
          "three_nn differs from knn_small_k_ref")
    ref = ops.fps_ref(x, 512)
    check(torch.equal(inds, ref) and torch.equal(
        sampled, ops.gather_points(x, ref)), "compat FPS differs from fps_ref")
    check(torch.equal(sampled_w, ops.gather_points(
        x, ops.fps_weighted(x.cpu(), w.cpu(), 512).to(dev))),
        "fps_weight card vs CPU")
    knn_rec, _ = _kernels_knn(bound, (("compat self k=3", x, x, 3),
                                      ("compat three_nn", x, new, 3)),
                              ("ties", new, torch.cat([new, new], 1)
                               .contiguous(), 3))
    fps_rec, _ = _zoo_chain(bound, x, (512,))
    vote_rec, levels = _zoo_chain(bound, scene_t, (2048, 1024, 512, 256))
    # the chain is the backbone's: its last level is SA4's points
    check(torch.equal(out_xyz, levels[-1]),
          "VoteNet SA levels' points differ from the FPS chain's")
    t0 = time.perf_counter()
    for _ in range(3):
        ops.fps_weighted(x, w, 512)
    sync()
    ms["fps_weighted_2x16000_512"] = (time.perf_counter() - t0) * 1e3 / 3
    ms["dynconv_topk_8x4096_k16"] = cuda_ms(
        lambda: ops.knn(gcn_x, gcn_x, gk), 3)

    # --- float64, card against the CPU, 2 clouds -------------------------
    t_cpu = time.perf_counter()
    compare = {}
    rel, cpu_s = _card_vs_cpu64("VoteNet SA", _votenet_backbone(seed=196),
                                (scene_t[:2].cpu(), height_t[:2].cpu()), dev)
    compare["votenet_sa"] = rel
    log(f"VoteNet SA levels float64 card vs CPU (2 clouds, CPU {cpu_s:.1f} "
        f"s): {rel}")
    check(max(rel.values()) <= REF64_RTOL, f"VoteNet card vs CPU {rel}")
    torch.manual_seed(197)
    q_xyz = scene_t[:2, :1024].cpu()
    assa = layers.ASSA(64, [64, 96, 128], {"NAME": "ballquery",
                                           "radius": 0.4, "nsample": 32})
    rel, _ = _card_vs_cpu64("ASSA", assa, (q_xyz, scene_t[:2, :4096].cpu(),
                                           torch.randn(2, 4096, 64)), dev)
    compare["assa"] = rel
    kme = layers.KMeansEmbed(256, 256)
    rel, _ = _card_vs_cpu64("KMeansEmbed", kme, (x[:, :4096].cpu(),), dev)
    compare["kmeans_embed"] = rel
    enc = layers.TransformerEncoder(384, 12, 6)
    tokens = torch.randn(2, 256, 384)
    rel, cpu_s = _card_vs_cpu64("TransformerEncoder", enc,
                                (tokens, 0.1 * torch.randn(2, 256, 384)),
                                dev)
    compare["transformer_encoder"] = rel
    for key in ("assa", "kmeans_embed", "transformer_encoder"):
        check(max(compare[key].values()) <= REF64_RTOL,
              f"{key} card vs CPU {compare[key]}")
    gcn64 = torch.nn.Sequential(*(layers.ResDynBlock(gC, "edge", k=gk)
                                  for _ in range(2)))
    cpu64 = gcn64.double().eval()
    card64 = copy.deepcopy(cpu64).to(dev)
    with torch.no_grad():
        gx64 = gcn_x[:2].double()
        gw, gg = cpu64(gx64.cpu()), card64(gx64).cpu()
    row_rel = ((gg - gw).abs().amax(-1) / gw.abs().amax())
    agree = float((row_rel <= REF64_RTOL).double().mean())
    compare["deepgcn_rows_agree"] = agree
    check(agree >= DEEPGCN_ROWS_AGREE, f"DeepGCN card vs CPU rows {agree}")
    cpu_seconds = time.perf_counter() - t_cpu
    log(f"float64 card vs CPU: {compare}")

    # --- (d) grid subsampling of a 150,000-point scan --------------------
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan

    pts, labels = _synthetic_scan(198, 150000)
    ops.grid_subsample_native(pts[:10], sample_dl=0.01)     # the build
    t0 = time.perf_counter()
    nat = ops.grid_subsample_native(pts, labels=labels, sample_dl=0.01)
    ms["grid_subsample_native_150000"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    npy = ops.grid_subsample(pts, labels=labels, sample_dl=0.01,
                             num_classes=17)
    ms["grid_subsample_numpy_150000"] = (time.perf_counter() - t0) * 1e3
    a, b = np.lexsort(nat[0].T), np.lexsort(npy[0].T)
    check(nat[0].shape == npy[0].shape
          and np.abs(nat[0][a] - npy[0][b]).max() <= 1e-4
          and np.array_equal(nat[1][a], npy[1][b]),
          "native grid_subsample differs from numpy")
    seconds = time.perf_counter() - t_phase
    log(f"phase 19 ms: {ms}; VoteNet SA fwd+bwd (8 x 20000) "
        f"{step_ms[1]:.1f} / {step_ms[2]:.1f}, peak {votenet_peak:.0f} MiB; "
        f"DeepGCN 2 ResDynBlocks fwd+bwd (8 x 4096, 64, k 16) "
        f"{gcn_ms[1]:.1f} / {gcn_ms[2]:.1f}, peak {gcn_peak:.0f} MiB; "
        f"{len(nat[0])} voxels")
    log(f"phase 19: {seconds:.1f} s (float64 CPU sides {cpu_seconds:.1f} s); "
        f"launches {launches}, by part {by_part}")
    return {"kernels": {"fps_compat": fps_rec, "fps_votenet": vote_rec,
                        "knn_compat": knn_rec},
            "launches": launches,
            "launches_by_shape": {
                "fps_compat_2x16000_512": by_part["compat"]["fps_cluster"],
                "fps_votenet_chain_8x20000":
                    by_part["votenet"]["fps_cluster"],
                "knn_compat_2x16000_k3": by_part["compat"]["knn_split"]},
            "ms": ms, "votenet_step_ms": step_ms, "votenet_peak_mb":
            votenet_peak, "deepgcn_step_ms": gcn_ms, "deepgcn_peak_mb":
            gcn_peak, "compare": compare, "seconds": seconds}


# --- phase 20: the data side ------------------------------------------------

# the OFF mesh trees of sample_pc: meshes a split at each sample size (the
# dense samples are 4x: (1, 4096) -> 1024 and (1, 8192) -> 2048)
SAMPLE_PC_TREES = {1024: {"train": 2, "test": 1}, 2048: {"train": 2}}
# ShapeNet pretraining: viewgen.yaml's model at full width over synthetic
# ShapeNet clouds of 1,024 points with 128 x 128 renders (the decoder's)
SHAPENET_OPTS = ("dataset.common.NAME=ShapeNet",
                 "dataset.common.num_points=1024", "num_points=1024",
                 "dataset.common.img_size=128")
# the first step's loss, card against CPU (dropout and stochastic depth
# off): tests/test_torch_trainer_switches.py's PRETRAIN_LOSS_RTOL
SHAPENET_STEP_RTOL = 1e-5
# the encoder's tapped features before that step, max |d| over max |f|, in
# float32: 12 blocks of float32 rounding (~1e-6) with room; in float64 the
# loss and those features (the searches are float32 on both, so equal)
# within SHAPENET_STEP64_TOL and every gradient within
# SHAPENET_GRAD64_TOL of its tensor's largest entry (at least 1e-6 of the
# largest of all: a bias before BatchNorm has none)
SHAPENET_FEAT32_TOL = 1e-4
SHAPENET_STEP64_TOL = 1e-10
SHAPENET_GRAD64_TOL = 1e-6
# the heritage loader with Cutmix and the new transforms that apply to
# ShapeNetPartNormal's items (pos, normals in x, per-point y), train split
HERITAGE_MIX = {"train": ["PointsToTensor", "PointCloudScaleAndTranslate",
                          "RandomDropout", "PointCloudJitter", "Cutmix"],
                "kwargs": {"prob": 1.0, "dropout_application_ratio": 0.5,
                           "mirror": (0.5, -1, -1)}}
# the cluster-contrast family on the card: (B, N, D) features, 17 classes,
# geot_tpu's defaults otherwise; float64 card against CPU on the same
# draws: loss and gradient relative to their largest entry, the new
# centres and queues (unit rows) absolute
CC_SHAPE = (2, 16000, 64)
CC_CLASSES = 17
CC64_TOL = 1e-9


def _icosphere(level: int):
    """A unit icosphere subdivided ``level`` times: (verts, faces)."""
    import numpy as np

    t = (1.0 + 5 ** 0.5) / 2
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(level):
        mid, out = {}, []

        def middle(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = out
    return np.stack(verts), np.asarray(faces, np.int64)


def _write_mesh_tree(root, sizes, seed):
    """OFF meshes (deformed icospheres of 2,562 vertices, every other one
    with the one-line ``OFF n m 0`` header) for each split of ``sizes``;
    returns their paths by split."""
    import numpy as np

    verts0, faces = _icosphere(4)
    rng = np.random.default_rng(seed)
    paths = {}
    for split, count in sizes.items():
        os.makedirs(os.path.join(root, split))
        for i in range(count):
            scale = rng.uniform(0.5, 2.0, 3)
            bump = 1 + 0.2 * np.sin(rng.uniform(1, 6) * verts0[:, :1])
            v = verts0 * scale * bump
            head = (f"OFF {len(v)} {len(faces)} 0\n" if i % 2 else
                    f"OFF\n{len(v)} {len(faces)} 0\n")
            p = os.path.join(root, split, f"mesh{i:02d}.off")
            with open(p, "w") as f:
                f.write(head + "".join(f"{a:.6f} {b:.6f} {c:.6f}\n"
                                       for a, b, c in v)
                        + "".join(f"3 {a} {b} {c}\n" for a, b, c in faces))
            paths.setdefault(split, []).append(p)
    return paths


def _data_sample_pc(bound: Bound, root: str):
    """(a) ``sample_pc`` on the card over OFF trees at 1,024 and 2,048
    points: the main path with the launch counts at 0 (one ``fps_cluster``
    a mesh, no other kernel), then each mesh's FPS against ``fps_ref`` on
    the card and the PLY files read back through ``IO.get``, and kernel 1
    timed kernel-only at both shapes."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.data.io import IO
    from geot_tpu_torch.data.sample_pc import (dense_surface_samples,
                                               read_off, sample_pc)
    from geot_tpu_torch.ops.fps import card_cluster_size

    dev = torch.device("cuda")
    trees, launches, ms = {}, {}, {}
    for n_pts, sizes in SAMPLE_PC_TREES.items():
        tree = os.path.join(root, f"meshes_{n_pts}")
        trees[n_pts] = _write_mesh_tree(tree, sizes, 200 + n_pts)
        n_mesh = sum(sizes.values())
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        sample_pc(tree, n_pts, device="cuda")
        torch.cuda.synchronize()
        ms[n_pts] = (time.perf_counter() - t) * 1e3
        got = dict(ops.LAUNCHES)
        want = _launch_counts(fps_cluster=n_mesh)
        check(got == want, f"sample_pc {n_pts}: launches {got}, expected "
              f"{want}")
        launches[n_pts] = got["fps_cluster"]
    rows = {}
    for n_pts, paths in trees.items():
        plan = ops.fps_plan(4 * n_pts, card_cluster_size(dev, 1))
        for split, files in paths.items():
            for p in files:
                verts, faces = read_off(p)
                dense = dense_surface_samples(verts, faces, 4 * n_pts,
                                              np.random.default_rng(0))
                x = torch.from_numpy(dense[None]).to(dev)
                got = ops.fps(x, n_pts)
                ref = ops.fps_ref(x, n_pts)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"sample_pc {p}: FPS differs "
                      f"from fps_ref at {int((got != ref).sum())} places")
                ply = p.replace(os.sep + split + os.sep,
                                os.sep + "pointclouds" + os.sep + split
                                + os.sep).replace(".off", ".ply")
                back = IO.get(ply)
                check(back.dtype == np.float32 and np.array_equal(
                    back, dense[ref[0].cpu().numpy()]),
                    f"sample_pc {ply}: the PLY is not the FPS samples")
        kernel_ms = graph_ms(lambda: ops.fps(x, n_pts), 10)
        plain = cuda_ms(lambda: ops.fps_ref(x, n_pts), 1)
        b_ms, b_by = _fps_bound(bound, 1, 4 * n_pts, n_pts)
        rows[n_pts] = {"ms": kernel_ms, "plain_ms": plain, "bound_ms": b_ms,
                       "bound_by": b_by, "max_abs_err": 0.0,
                       "launches": launches[n_pts], "plan": list(plan)}
        log(f"sample_pc {n_pts}: {sum(map(len, paths.values()))} meshes in "
            f"{ms[n_pts]:.1f} ms, {launches[n_pts]} fps_cluster launches; "
            f"FPS (1,{4 * n_pts})->{n_pts} plan {plan.route} C={plan.C}, "
            f"bit-equal to fps_ref, PLYs read back; kernel "
            f"{kernel_ms:.4f} ms, plain {plain:.1f} ms, bound {b_ms:.5f} ms "
            f"({b_by})")
    return rows, ms


def _data_shapenet(bound: Bound, root: str):
    """(b) ShapeNet pretraining at ``viewgen.yaml``'s width over synthetic
    ShapeNet at 1,024 points: kernel 1 at the tokenizer's (2, 1024) -> 512
    against ``fps_ref``; 5 steps timed (a launch each, peak memory); the
    first step's loss card against CPU; ``parse_and_run`` for one epoch and
    its validation with the launches it implies."""
    import copy

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.core.config import EasyConfig
    from geot_tpu_torch.data.build import build_dataloader_from_cfg
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.pretrain import (make_pretrain_step,
                                                pretrain_batch)
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    here = os.path.dirname(os.path.abspath(__file__))
    viewgen = os.path.join(here, "cfgs", "tooth_pretrain", "viewgen.yaml")
    cfg = EasyConfig()
    cfg.load(viewgen, recursive=True)
    cfg.update(list(SHAPENET_OPTS))
    dev = torch.device("cuda")
    B, G = int(cfg.batch_size), int(cfg.model.encoder_args.num_group)
    loader = build_dataloader_from_cfg(B, cfg.dataset, None, split="train",
                                       seed=int(cfg.seed))
    loader.set_epoch(1)
    batches = [b for _, b in zip(range(5), loader)]
    N = batches[0]["pos"].shape[1]
    check(batches[0]["imgs"].shape[2:4] == (128, 128),
          f"ShapeNet renders {batches[0]['imgs'].shape}")
    pos = torch.from_numpy(batches[0]["pos"]).to(dev).contiguous()
    got, ref = ops.fps(pos, G), ops.fps_ref(pos, G)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"fps ({B},{N})->{G}: indices differ from "
          f"fps_ref at {int((got != ref).sum())} places")
    kernel_ms = graph_ms(lambda: ops.fps(pos, G), 10)
    plain = cuda_ms(lambda: ops.fps_ref(pos, G), 1)
    b_ms, b_by = _fps_bound(bound, B, N, G)
    row = {"ms": kernel_ms, "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by, "max_abs_err": 0.0}

    one = _launch_counts(fps_cluster=1)
    state = TrainState.create(cfg, cfg.model, seed=int(cfg.seed), device=dev)
    step = make_pretrain_step(cfg)
    lr = build_scheduler_from_cfg(cfg)(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step_ms, launched = [], 0
    for n, b in enumerate(batches):
        b = pretrain_batch(b, dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        loss = float(step(state, b, lr)["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        check(math.isfinite(loss), f"ShapeNet pretrain step {n}: {loss}")
        check(dict(ops.LAUNCHES) == one, f"ShapeNet pretrain step {n}: "
              f"launches {dict(ops.LAUNCHES)}, expected {one}")
        launched += 1
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
    del state
    torch.cuda.empty_cache()

    # the first step from the same weights and batch, card and CPU, in
    # float32 and in float64. At random init the decoder's sigmoid sits
    # near 0.5, where a float32 step is 6e-8: most pixels, and so the
    # float32 loss, come out bit-equal whatever the trunk's last bits, so
    # the trunk's own output (the encoder's tapped features, eval mode,
    # before the step) is held too, and in float64 the loss, those
    # features and every gradient
    nd = copy.deepcopy(cfg)
    nd.update(["model.encoder_args.drop_path_rate=0.0"])
    step_nd = make_pretrain_step(nd)
    first = {}
    for dt in (torch.float32, torch.float64):
        res = {}
        for name in ("cuda", "cpu"):
            st = TrainState.create(nd, nd.model, seed=int(cfg.seed),
                                   device=name)
            if name == "cuda":
                weights = {k: v.clone()
                           for k, v in st.model.state_dict().items()}
            else:
                st.model.load_state_dict(weights)
            st.model.to(dt)
            b = {k: (v.to(dt) if v.is_floating_point() else v)
                 for k, v in pretrain_batch(batches[0], name).items()}
            st.model.eval()
            with torch.no_grad():
                feats = st.model.encoder.forward_cls_feat(b)[0]
            ops.reset_launches()
            t = time.perf_counter()
            with cpu_search_memo():
                loss = float(step_nd(st, b, lr)["loss"])
            secs = time.perf_counter() - t
            if name == "cuda":
                check(dict(ops.LAUNCHES) == one,
                      f"ShapeNet card step launches {dict(ops.LAUNCHES)}")
                launched += 1
            res[name] = (loss, feats.double().cpu(), secs, {
                n: p.grad.double().cpu()
                for n, p in st.model.named_parameters()
                if p.grad is not None})
            del st
        (lg, fg, _, gg), (lc, fc, cpu_s, gc) = res["cuda"], res["cpu"]
        gmax = max(float(v.abs().max()) for v in gc.values())
        grad = max((float((gg[n] - v).abs().max())
                    / max(float(v.abs().max()), 1e-6 * gmax), n)
                   for n, v in gc.items())
        first[str(dt)[6:]] = {
            "card": lg, "cpu": lc, "rel": abs(lg - lc) / abs(lc),
            "feats": float((fg - fc).abs().max() / fc.abs().max()),
            "grad": grad, "grads": (len(gg), len(gc)), "cpu_s": cpu_s}
    torch.cuda.empty_cache()
    f32, f64 = first["float32"], first["float64"]
    log("ShapeNet first step card vs CPU: " + "; ".join(
        f"{k} loss {v['card']!r} vs {v['cpu']!r} ({v['rel']:.2e} "
        f"relative), encoder features max |d| / max |f| {v['feats']:.2e}, "
        f"worst gradient {v['grad'][0]:.2e} ({v['grad'][1]}), CPU step "
        f"{v['cpu_s']:.1f} s" for k, v in first.items()))
    check(f32["rel"] <= SHAPENET_STEP_RTOL, f"ShapeNet first step card vs "
          f"CPU, float32 loss: {f32}")
    check(f32["feats"] <= SHAPENET_FEAT32_TOL, f"ShapeNet encoder features "
          f"card vs CPU, float32: {f32['feats']:.3e}")
    check(f64["grads"][0] == f64["grads"][1] > 0, f"ShapeNet gradients: "
          f"{f64['grads']} tensors on the card and the CPU")
    check(f64["rel"] <= SHAPENET_STEP64_TOL
          and f64["feats"] <= SHAPENET_STEP64_TOL
          and f64["grad"][0] <= SHAPENET_GRAD64_TOL,
          f"ShapeNet first step card vs CPU, float64: {f64}")
    rel = f32["rel"]

    # the trainer: one epoch and its validation
    steps = len(loader)
    val_loader = build_dataloader_from_cfg(
        int(cfg.batch_size_val), cfg.dataset, None, split="val")
    n_val = len(val_loader)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = train_mod.parse_and_run(["--cfg", viewgen, *SHAPENET_OPTS,
                                   "epochs=1", "val_freq=1",
                                   f"root_dir={root}", "device=cuda"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    want = _launch_counts(fps_cluster=steps + n_val)
    check(dict(ops.LAUNCHES) == want, f"ShapeNet trainer launches "
          f"{dict(ops.LAUNCHES)}, expected {want}")
    check(math.isfinite(res["val_loss"]), f"ShapeNet trainer {res}")
    launched += steps + n_val
    row["launches"] = launched
    log(f"ShapeNet pretraining (viewgen.yaml width, {N} points, batch {B}): "
        f"fps ({B},{N})->{G} bit-equal to fps_ref, kernel {kernel_ms:.4f} "
        f"ms, plain {plain:.1f} ms, bound {b_ms:.5f} ms ({b_by}); steps "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms (median after the "
        f"first {statistics.median(step_ms[1:]):.2f}), peak {peak_mb:.0f} "
        f"MiB above the resident {resident / 2 ** 20:.0f} MiB; first step "
        f"card vs CPU float32 {rel:.2e} relative (bound "
        f"{SHAPENET_STEP_RTOL}); trainer {steps} steps + {n_val} val "
        f"batches in {run_s:.1f} s, val loss {res['val_loss']:.6f}")
    return row, {"step_ms": step_ms, "peak_mb": peak_mb, "run_s": run_s,
                 "first_step_rel": rel, "first_step": first,
                 "val_loss": res["val_loss"]}


def _data_heritage_mix():
    """(c) ``pointnet2part.yaml`` with ``HERITAGE_MIX`` on its train split:
    the loader's Cutmix, batches equal with 1 thread and the config's
    threads, mixed (against ``prob`` 0), then 3 steps on the card with the
    launches of phase 17."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.data.build import build_dataloader_from_cfg
    from geot_tpu_torch.engine import partseg as partseg_mod
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    dev = torch.device("cuda")
    cfg = _zoo_cfg_at(_heritage_path("pointnet2part"), "seed=0")
    cfg.datatransforms = HERITAGE_MIX

    def batches(tf, workers):
        loader = build_dataloader_from_cfg(
            int(cfg.batch_size), cfg.dataset, tf, split="trainval", seed=0,
            dataloader_cfg={"num_workers": workers}, is_train=True)
        loader.set_epoch(1)
        return loader, [b for _, b in zip(range(3), loader)]

    loader, mixed = batches(HERITAGE_MIX, 4)
    check([type(m).__name__ for m in loader.batch_mixers] == ["Cutmix"],
          f"heritage loader mixers {loader.batch_mixers}")
    _, one_thread = batches(HERITAGE_MIX, 1)
    _, unmixed = batches(dict(HERITAGE_MIX, kwargs=dict(
        HERITAGE_MIX["kwargs"], prob=0.0)), 4)
    for a, b in zip(mixed, one_thread):
        check(set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                       for k in a),
              "heritage batches differ with 1 and 4 loader threads")
    check(all(not np.array_equal(a["y"], u["y"])
              for a, u in zip(mixed, unmixed)), "Cutmix mixed no batch")
    state = TrainState.create(cfg, cfg.model, seed=0, device=dev)
    step = make_supervised_step(cfg)
    lr = build_scheduler_from_cfg(cfg)(1)
    f, k = _HERITAGE_PER_FORWARD["pointnet2part"]
    want = _launch_counts(fps_cluster=f, knn_split=k)
    total = dict.fromkeys(ops.LAUNCHES, 0)
    step_ms = []
    for n, b in enumerate(mixed):
        b = partseg_mod._batch(b, dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        loss = float(step(state, b, lr)["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        check(math.isfinite(loss), f"mixed heritage step {n}: {loss}")
        check(dict(ops.LAUNCHES) == want, f"mixed heritage step {n}: "
              f"launches {dict(ops.LAUNCHES)}, expected {want}")
        for key, v in ops.LAUNCHES.items():
            total[key] += v
    del state
    torch.cuda.empty_cache()
    log(f"pointnet2part with {HERITAGE_MIX['train']}: batches equal with 1 "
        f"and 4 threads, each mixed; steps "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms, launches a step "
        f"{want}")
    return total, step_ms


def _cc_inputs(seed: int):
    import numpy as np

    B, N, D = CC_SHAPE
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, CC_CLASSES, (B, N))
    return {"feats": rng.standard_normal((B, N, D)),
            "teacher": rng.standard_normal((B, N, D)),
            "pred": pred,
            "label": np.where(rng.uniform(size=(B, N)) < 0.8, pred,
                              rng.integers(0, CC_CLASSES, (B, N))),
            "conf": rng.uniform(size=(B, N)),
            "label2": rng.integers(0, CC_CLASSES, (B, N)),
            "mask": rng.uniform(size=(B, N)) < 0.3}


def _cc_run(kind, K, data, state, draws, dev, dtype):
    """One forward and backward of ``kind`` on ``dev`` in ``dtype``:
    (loss, the feature gradient, the new state or None, ms)."""
    import torch

    from geot_tpu_torch.losses import cluster_contrast as cc

    def t(x):
        x = torch.from_numpy(x).to(dev)
        return x.to(dtype) if x.is_floating_point() else x

    st = cc.ClassContrastState(state.centers.to(dev, dtype),
                               state.queues.to(dev, dtype),
                               state.ptrs.to(dev))
    dr = tuple(d.to(dev, dtype) for d in draws)
    feats = t(data["feats"]).requires_grad_()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "pcc_top2":
        loss = cc.pcc_top2_loss(st, feats, t(data["pred"]),
                                t(data["label2"]), t(data["mask"]),
                                t(data["conf"]), CC_CLASSES, K,
                                draws=dr[0])
        new = None
    else:
        loss, new = cc.class_contrast_loss(
            st, feats, t(data["pred"]), t(data["label"]), t(data["conf"]),
            num_classes=CC_CLASSES, subclasses=K,
            teacher_feats=t(data["teacher"]) if kind == "teacher" else None,
            draws=dr)
    loss.backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return loss.detach().cpu(), feats.grad.cpu(), new, (
        time.perf_counter() - t0) * 1e3


def _data_cluster_contrast():
    """(d) the cluster-contrast family on the card at ``CC_SHAPE``:
    ``class_contrast_loss`` with 1 and 6 subclasses and with teacher
    features, ``pcc_top2_loss`` and ``pseudo_label_from_prototype``,
    forward and backward; ms and peak memory in float32 (the second of two
    runs), then float64 card against CPU on the same draws and state."""
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.losses import cluster_contrast as cc

    dev = torch.device("cuda")
    data = _cc_inputs(210)
    B, N, D = CC_SHAPE
    out = {}
    ops.reset_launches()
    for kind, K in (("class", 1), ("subclass", 6), ("teacher", 6),
                    ("pcc_top2", 6)):
        gen = torch.Generator().manual_seed(211 + K)
        state = cc.ClassContrastState.create(gen, CC_CLASSES * K, D,
                                             dtype=torch.float64)
        M = B * CC_CLASSES * K * (100 // K if K > 1 else 100)
        draws = (torch.rand((B, N), generator=gen, dtype=torch.float64),
                 torch.rand((M,), generator=gen, dtype=torch.float64))
        _cc_run(kind, K, data, state, draws, dev, torch.float32)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, _, _, ms32 = _cc_run(kind, K, data, state, draws, dev,
                                torch.float32)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        lg, gg, ng, ms64 = _cc_run(kind, K, data, state, draws, dev,
                                   torch.float64)
        lc, gc, nc, cpu_ms = _cc_run(kind, K, data, state, draws,
                                     torch.device("cpu"), torch.float64)
        err = {"loss": float((lg - lc).abs() / lc.abs()),
               "grad": float((gg - gc).abs().max() / gc.abs().max())}
        if nc is not None:
            check(torch.equal(ng.ptrs.cpu(), nc.ptrs),
                  f"cluster contrast {kind}: queue pointers card vs CPU")
            err["centers"] = float((ng.centers.cpu() - nc.centers).abs()
                                   .max())
            err["queues"] = float((ng.queues.cpu() - nc.queues).abs().max())
        check(all(math.isfinite(v) and v <= CC64_TOL for v in err.values())
              and math.isfinite(float(lg)),
              f"cluster contrast {kind} (K={K}) float64 card vs CPU {err}")
        if kind == "subclass":
            fe = torch.from_numpy(data["feats"])
            pg, zg = cc.pseudo_label_from_prototype(
                cc.ClassContrastState(state.centers.to(dev), None, None),
                fe.to(dev), CC_CLASSES, K)
            pc, zc = cc.pseudo_label_from_prototype(state, fe, CC_CLASSES,
                                                    K)
            err["pseudo_logits"] = float((zg.cpu() - zc).abs().max())
            check(torch.equal(pg.cpu(), pc) and err["pseudo_logits"]
                  <= CC64_TOL, f"pseudo labels card vs CPU {err}")
        out[f"{kind}_K{K}"] = {"ms_float32": ms32, "peak_mb_float32": peak,
                               "ms_float64": ms64, "cpu_ms_float64": cpu_ms,
                               "err_float64": err, "loss": float(lg)}
        log(f"cluster contrast {kind} K={K} {CC_SHAPE}: float32 fwd+bwd "
            f"{ms32:.1f} ms, peak {peak:.0f} MiB; float64 card {ms64:.1f} "
            f"ms, CPU {cpu_ms:.0f} ms; card vs CPU {err} (bound {CC64_TOL})")
    check(dict(ops.LAUNCHES) == _launch_counts(),
          f"cluster contrast launched kernels {dict(ops.LAUNCHES)}")
    return out


def phase_data(bound: Bound):
    """Phase 20: the data side. (a) ``sample_pc`` over OFF trees, (b)
    ShapeNet pretraining at full width, (c) a heritage loader with Cutmix,
    (d) the cluster-contrast family. Each main path runs with the launch
    counts at 0 and is read just after."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    log("phase 20: the data side (sample_pc, ShapeNet pretraining, the "
        "heritage loader's Cutmix, cluster contrast)")
    root = tempfile.mkdtemp(prefix="geot_data_side_")
    try:
        rows, sample_ms = _data_sample_pc(bound, root)
        shapenet_row, shapenet = _data_shapenet(bound, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    heritage, mix_step_ms = _data_heritage_mix()
    contrast = _data_cluster_contrast()
    seconds = time.perf_counter() - t_phase
    launches = _launch_counts(fps_cluster=sum(r["launches"]
                                              for r in rows.values())
                              + shapenet_row["launches"])
    for key, v in heritage.items():
        launches[key] += v
    log(f"phase 20: {seconds:.1f} s; launches {launches}")
    return {"kernels": {"sample_pc_1024": rows[1024],
                        "sample_pc_2048": rows[2048],
                        "shapenet_pretrain": shapenet_row},
            "launches": launches, "sample_pc_ms": sample_ms,
            "shapenet": shapenet, "mix_step_ms": mix_step_ms,
            "cluster_contrast": contrast, "seconds": seconds}


# --dp-step-ms: phase 14's two-rank flagship trainer (gloo, both ranks on
# one card, the global batch 2 + 2 + 2 at 16,000 points) for 8 steps, in
# each checkout given, in the order given: to compare two commits on one
# card, run parent, change, change, parent
DP_MS_SPLITS = {"semi_l_train_0.2.txt": tuple(range(16)),
                "semi_u_train_0.2.txt": tuple(range(16, 32)),
                "testing.txt": (0,)}


def dp_step_ms(dirs) -> int:
    """Each step's milliseconds on rank 0 (to the losses on the host, the
    trainer's ``GEOT_LOG_STEP_LOSS`` lines) of the two-rank trainer run
    from each checkout in ``dirs``; one JSON line a run, then the card's
    ``nvidia-smi`` name and power limit."""
    import shutil
    import statistics
    import tempfile

    _, smi, _ = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan

    dirs = [os.path.abspath(d) for d in dirs]
    root = tempfile.mkdtemp(prefix="geot_dp_ms_")
    try:
        tree = os.path.join(root, "teeth3ds")
        os.makedirs(tree)
        _write_teeth3ds(tree, [(f"P{i:03d}", i % 2,
                                *_synthetic_scan(500 + i, 40000))
                               for i in range(32)], DP_MS_SPLITS)
        # every checkout's kernels, built before its ranks start
        builds = [subprocess.Popen(
            [sys.executable, "-c",
             "from geot_tpu_torch.ops import _build; _build.build_info()"],
            cwd=d, env=dict(os.environ, PYTHONPATH=d))
            for d in dict.fromkeys(dirs)]
        codes = [p.wait(timeout=900) for p in builds]
        check(codes == [0] * len(codes), f"kernel builds: {codes}")
        for i, d in enumerate(dirs):
            run = os.path.join(root, f"run{i}")
            proc = subprocess.run(
                [sys.executable, "-m", "geot_tpu_torch.engine.launch",
                 "--nprocs", "2", "--run-dir", run, "--", "--cfg",
                 os.path.join(d, "cfgs", "tooth_semi",
                              "transformer_finetune_fixmatch_ntm.yaml"),
                 f"dataset_l.common.data_root={tree}",
                 f"dataset_u.common.data_root={tree}", "epochs=1",
                 "seed=3", "test_freq=100", "save_freq=100",
                 *_DP_NO_DROPOUT],
                cwd=d, env=_rank_env(d), timeout=600, capture_output=True,
                text=True)
            check(proc.returncode == 0, f"{d}: two-rank launch failed:\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}")
            _, ms = _steplosses(open(os.path.join(run, "rank0.log")).read())
            check(len(ms) == 8, f"{d}: step ms {ms}")
            print(json.dumps({"checkout": d, "step_ms": ms,
                              "median_after_first": statistics.median(
                                  ms[1:])}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(smi, flush=True)
    return 0


def resume_check(root: str, extra=()) -> int:
    """``--resume-check ROOT [k=v ...]`` (phases 8 and 16 run it in a child
    process with ``CUBLAS_WORKSPACE_CONFIG`` set): with deterministic
    algorithms on, the flagship for 2 epochs (with the overrides), then a
    resume from its epoch-1 checkpoint; prints the epoch-2 scalars of both
    as one ``RESUME_CHECK`` JSON line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    sys.modules["wandb"] = None      # see phase_switches
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    common = [f"root_dir={root}", "val_freq=1", "test_freq=2", "save_freq=1",
              *extra]
    train_mod.parse_and_run(["--cfg", cfg_path, "epochs=2", *common])
    run_dir = os.path.join(root, "tooth_semi",
                           os.listdir(os.path.join(root, "tooth_semi"))[0])
    scalars = os.path.join(run_dir, "scalars.jsonl")
    a2, n_lines = _epoch_scalars(scalars)
    e1 = ckpt_path(os.path.join(run_dir, "checkpoint"),
                   os.path.basename(run_dir), "E1")
    train_mod.parse_and_run(["--cfg", cfg_path, "mode=resume",
                             f"pretrained_path={e1}", "epochs=2", *common])
    b2, _ = _epoch_scalars(scalars, skip=n_lines)
    print("RESUME_CHECK " + json.dumps({"a": a2, "b": b2}), flush=True)
    return 0


_SPREAD_LOSSES = ("train_loss", "train_loss_l", "train_loss_u",
                  "insT_threed_loss")


def resume_spread(pairs: int) -> int:
    """``--resume-spread PAIRS``: phase 8's run A twice per pair, with the
    card's default (non-deterministic) backward, and phase 8's run B (a
    resume from the first run's epoch-1 checkpoint). Prints, per loss term,
    the relative difference of the epoch-2 values between the two
    uninterrupted runs and between the first run and its resume, then one
    ``RESUME_SPREAD`` JSON line with every pair and the worst of each."""
    import shutil
    import tempfile

    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path

    phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")

    def rel(x, y):
        return {t: abs(y[t] - x[t]) / max(abs(x[t]), 1e-30)
                for t in _SPREAD_LOSSES}

    def run(root, *extra):
        common = [f"root_dir={root}", "val_freq=1", "test_freq=2",
                  "save_freq=1"]
        train_mod.parse_and_run(["--cfg", cfg_path, "epochs=2", *common,
                                 *extra])
        run_dir = os.path.join(root, "tooth_semi",
                               os.listdir(os.path.join(root, "tooth_semi"))[0])
        return run_dir, os.path.join(run_dir, "scalars.jsonl")

    out = []
    for i in range(pairs):
        roots = [tempfile.mkdtemp(prefix=f"geot_spread{i}{x}_")
                 for x in "ab"]
        try:
            run_dir, sc_a = run(roots[0])
            a2, n_lines = _epoch_scalars(sc_a)
            _, sc_a2 = run(roots[1])
            a2b, _ = _epoch_scalars(sc_a2)
            e1 = ckpt_path(os.path.join(run_dir, "checkpoint"),
                           os.path.basename(run_dir), "E1")
            run(roots[0], "mode=resume", f"pretrained_path={e1}")
            b2, _ = _epoch_scalars(sc_a, skip=n_lines)
        finally:
            for r in roots:
                shutil.rmtree(r, ignore_errors=True)
        rec = {"a": {t: a2[t] for t in _SPREAD_LOSSES},
               "a_again": {t: a2b[t] for t in _SPREAD_LOSSES},
               "resume": {t: b2[t] for t in _SPREAD_LOSSES},
               "uninterrupted_rel": rel(a2, a2b), "resume_rel": rel(a2, b2)}
        out.append(rec)
        log(f"pair {i}: uninterrupted A vs A' " + ", ".join(
            f"{t} {v:.3e}" for t, v in rec["uninterrupted_rel"].items())
            + "; A vs resume B " + ", ".join(
            f"{t} {v:.3e}" for t, v in rec["resume_rel"].items()))
    worst = {kind: {t: max(r[kind][t] for r in out) for t in _SPREAD_LOSSES}
             for kind in ("uninterrupted_rel", "resume_rel")}
    # every two of the 2 x PAIRS uninterrupted runs are a pair of
    # uninterrupted runs: the largest |y - x| / |x| among them
    worst["uninterrupted_all_pairs_rel"] = {
        t: (max(v) - min(v)) / min(abs(x) for x in v) for t, v in (
            (t, [r[k][t] for r in out for k in ("a", "a_again")])
            for t in _SPREAD_LOSSES)}
    log(f"worst over {pairs} pairs: {worst}")
    print("RESUME_SPREAD " + json.dumps({"pairs": out, "worst": worst}),
          flush=True)
    return 0


def main() -> int:
    if "--resume-check" in sys.argv[1:]:
        at = sys.argv.index("--resume-check")
        return resume_check(sys.argv[at + 1], sys.argv[at + 2:])
    if "--hessian-cpu" in sys.argv[1:]:
        at = sys.argv.index("--hessian-cpu")
        return hessian_cpu(*sys.argv[at + 1:at + 3])
    if "--dp-step-ms" in sys.argv[1:]:
        return dp_step_ms(sys.argv[sys.argv.index("--dp-step-ms") + 1:])
    if "--resume-spread" in sys.argv[1:]:
        return resume_spread(int(
            sys.argv[sys.argv.index("--resume-spread") + 1]))
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    name, smi, limit_w = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    phase_build()
    recs = phase_kernels(Bound(limit_w))
    scans, results, serving, _, _ = phase_serving()
    phase_http(scans, results)
    train = phase_train()
    trainer = phase_trainer()
    fast = phase_fast_serving(scans)
    fast_trainer = phase_fast_trainer()
    branches = phase_branches(Bound(limit_w), train["state"].cm)
    zoo = phase_zoo(Bound(limit_w))
    files = phase_files(Bound(limit_w))
    export_dp = phase_export_dp(Bound(limit_w))
    pretrain = phase_pretrain(Bound(limit_w), smi)
    switches = phase_switches(Bound(limit_w), train)
    heritage = phase_heritage(Bound(limit_w))
    registry = phase_registry(Bound(limit_w), train["semi64_ref"])
    reference = phase_reference(Bound(limit_w))
    data = phase_data(Bound(limit_w))
    if "--profile" in sys.argv[1:]:
        phase_profile(scans, train)
    # launches on the main paths: 3 served scans, the train run (2 cm
    # batches + 3 steps), the trainer's run A, the fast scans (12, votes,
    # ensemble, stream), the fast trainer's runs and the branch steps and
    # trainer of phase 11; the pruned kNN and its plan's kernels run every
    # upsample of a whole scan; the first versions of FPS and kNN, and
    # fps_bucket (the route of clouds past C x 4,096 points), on no path
    trained = {k: sum(c[k] for c in train["cm_batches"] + train["per_step"])
               for k in serving}
    per_step = train["per_step"][0]
    log(f"launches: serving {serving}, training {trained}, trainer "
        f"{trainer['launches']}, fast serving {fast['launches']}, fast "
        f"trainer {fast_trainer['launches']}, semi-step branches "
        f"{branches['launches']}, supervised zoo {zoo['launches']}, files "
        f"and the serving CLI {files['launches']}, export and data "
        f"parallel {export_dp['launches']}, pretraining and the graft "
        f"{pretrain['launches']}, the trainer's other switches "
        f"{switches['launches']}, the heritage tasks "
        f"{heritage['launches']}, the rest of the registry "
        f"{registry['launches']}, the reference layer and op API "
        f"{reference['launches']}, the data side {data['launches']}")

    def entry(name, replaces, source=None):
        return {"name": name, "route": "cuda",
                "source": f"geot_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces,
                "launches": (serving[name] + trained[name]
                             + trainer["launches"][name]
                             + fast["launches"][name]
                             + fast_trainer["launches"][name]
                             + branches["launches"][name]
                             + zoo["launches"][name]
                             + files["launches"].get(name, 0)
                             + export_dp["launches"][name]
                             + pretrain["launches"][name]
                             + switches["launches"][name]
                             + heritage["launches"][name]
                             + registry["launches"][name]
                             + reference["launches"][name]
                             + data["launches"][name]),
                "launches_serving_3_scans": serving[name],
                "launches_train_step": per_step[name],
                "launches_trainer_run": trainer["launches"][name],
                "launches_fast_scan": _PER_FAST_SCAN.get(name, 0),
                "launches_fast_serving": fast["launches"][name],
                "launches_fast_trainer": fast_trainer["launches"][name],
                "launches_semi_branches": branches["launches"][name],
                "launches_supervised_zoo": zoo["launches"][name],
                "launches_files_and_cli": files["launches"].get(name, 0),
                "launches_export_and_dp": export_dp["launches"][name],
                "launches_pretrain_and_graft": pretrain["launches"][name],
                "launches_trainer_switches": switches["launches"][name],
                "launches_heritage_tasks": heritage["launches"][name],
                "launches_registry_rest": registry["launches"][name],
                "launches_reference_layers": reference["launches"][name],
                "launches_data_side": data["launches"][name],
                "library_ms": None, **recs[name]}

    kernels = [
        entry("fps_cluster", "geot_tpu/ops/pallas_fps.py:231"),
        entry("fps", "geot_tpu/ops/pallas_fps.py:231"),
        entry("knn_split", "geot_tpu/ops/pallas_knn.py:98"),
        entry("knn_small_k", "geot_tpu/ops/pallas_knn.py:98"),
        entry("fps_bucket", "geot_tpu/ops/pallas_fps.py:181"),
        entry("knn_small_k_pruned", "geot_tpu/ops/pallas_knn_pruned.py:104"),
        # the pruned kNN's plan on the card; in geot_tpu XLA computes it
        # outside the pallas_call of pallas_knn_pruned.py:104
        entry("morton", "geot_tpu/ops/morton.py:28"),
        entry("knn_pruned_prepare", "geot_tpu/ops/pallas_knn_pruned.py:130",
              source="knn_small_k_pruned"),
        # kernel 2 at the self-search of a whole cloud (Poly1FocalLoss_U_top2):
        # launches at that shape in phase 11
        {"name": "knn_split_self_search_2x16000_k2", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         **branches["self_search"]},
        # kernels 1 and 2 at the supervised zoo's shapes (phase 12): the FPS
        # chain of PointNet++ and PointMLP at B = 4 and the decoders' 3-NN
        # searches; launches at those shapes in phase 12
        {"name": "fps_cluster_zoo_chain_4x16000", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         "launches": sum(zoo["launches_by_shape"]["fps_chain"].values()),
         **zoo["kernels"]["fps_chain"]},
        {"name": "knn_split_zoo_decoders_4x_k3", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         "launches": sum(zoo["launches_by_shape"]["knn_decoder"].values()),
         **zoo["kernels"]["knn_decoder"]},
        # kernels 1 and 2 at phase 13's shapes: a served zoo scan (B = 1)
        # and the upsample of a 150,000-point scan; launches at those
        # shapes in phase 13
        {"name": "fps_cluster_zoo_chain_1x16000", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         "launches": sum(files["launches_by_shape"]["fps_chain"].values()),
         **files["kernels"]["fps_chain"]},
        {"name": "knn_split_zoo_decoders_1x_k3", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         "launches": sum(files["launches_by_shape"]["knn_decoder"]
                         .values()),
         **files["kernels"]["knn_decoder"]},
        # kernel 2 at that upsample, timed beside the route that now serves
        # it (knn_route: the pruned kernel, the next row), so no launch
        {"name": "knn_split_upsample_155648x16000_k3", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         "launches": 0, **files["kernels"]["knn_upsample"]},
        {"name": "knn_small_k_pruned_upsample_155648x16000_k3",
         "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_small_k_pruned.cu",
         "replaces": "geot_tpu/ops/pallas_knn_pruned.py:104",
         "library_ms": None,
         "launches": files["launches_by_shape"]["knn_upsample"],
         **recs["knn_small_k_pruned"]["scan_150000"], "max_abs_err": 0.0},
        # kernels 1 and 2 called through the custom ops geot::fps and
        # geot::knn_small_k (ms: the op; direct_ms: the wrapper without the
        # op's dispatch); launches: phase 14's main paths in this process
        # and the two ranks' steps
        {"name": "fps_cluster_via_geot_op_1x16000", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         "launches": export_dp["launches"]["fps_cluster"],
         **export_dp["kernels"]["fps_cluster"]},
        {"name": "knn_split_via_geot_op_scan_8_searches", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         "launches": export_dp["launches"]["knn_split"],
         **export_dp["kernels"]["knn_split"]},
        # kernel 1 at the pretraining stage's tokenizer, (2, 16000) -> 512
        # (phase 15): a launch per pretraining step, validation batch and
        # forward
        {"name": "fps_cluster_pretrain_2x16000_512", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         **pretrain["kernels"]["fps_pretrain"]},
        # kernels 1 and 2 at the heritage tasks' shapes (phase 17): the FPS
        # chains of classification at (32, 1024) and of part segmentation
        # at (8, 2048), and the part decoders' k = 3 searches; launches at
        # those shapes in phase 17's steps and trainer runs
        {"name": "fps_cluster_heritage_chains_32x1024_8x2048",
         "route": "cuda", "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         "launches": sum(heritage["launches_by_shape"]["fps_chains"]
                         .values()),
         **heritage["kernels"]["fps_chains"]},
        {"name": "knn_split_heritage_part_decoders_8x_k3", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         "launches": sum(heritage["launches_by_shape"]["knn_decoder"]
                         .values()),
         **heritage["kernels"]["knn_decoder"]},
        # kernels 1 and 2 at the rest of the registry's shapes (phase 18):
        # the seg variants' FPS at (4, 16000) -> 8192 and their 7 searches
        # at B = 4, and the cls-token encoder's FPS at (32, 1024) -> 256;
        # launches at those shapes in phase 18
        {"name": "fps_cluster_seg_variants_4x16000_8192", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         "launches": registry["launches_by_shape"]["fps_4x16000_8192"],
         **registry["kernels"]["fps_4x16000"]},
        {"name": "knn_split_seg_variants_4x16000_7_searches",
         "route": "cuda", "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         "launches": registry["launches_by_shape"]["knn_B4"],
         **registry["kernels"]["knn_4x16000"]},
        {"name": "fps_cluster_cls_token_32x1024_256", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         "launches": registry["launches_by_shape"]["fps_32x1024_256"],
         **registry["kernels"]["fps_32x1024"]},
        # kernels 1 and 2 at the reference op API's shapes (phase 19): the
        # compat FPS at (2, 16000) -> 512, VoteNet's SA chain (8, 20000) ->
        # 2048 -> 1024 -> 512 -> 256, and the compat k = 3 searches at
        # (2, 16000); launches at those shapes in phase 19's main path
        {"name": "fps_cluster_compat_2x16000_512", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         "launches": reference["launches_by_shape"]["fps_compat_2x16000_512"],
         **reference["kernels"]["fps_compat"]},
        {"name": "fps_cluster_votenet_chain_8x20000_2048", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         "launches": reference["launches_by_shape"][
             "fps_votenet_chain_8x20000"],
         **reference["kernels"]["fps_votenet"]},
        {"name": "knn_split_compat_2x16000_k3", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         "launches": reference["launches_by_shape"]["knn_compat_2x16000_k3"],
         **reference["kernels"]["knn_compat"]},
        # kernel 1 on the data side (phase 20): sample_pc's thinning of a
        # mesh's dense samples, (1, 4096) -> 1024 and (1, 8192) -> 2048 (a
        # launch a mesh), and ViewGen's tokenizer over ShapeNet, (2, 1024)
        # -> 512 (a launch a step and validation batch)
        {"name": "fps_cluster_sample_pc_1x4096_1024", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         **data["kernels"]["sample_pc_1024"]},
        {"name": "fps_cluster_sample_pc_1x8192_2048", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         **data["kernels"]["sample_pc_2048"]},
        {"name": "fps_cluster_shapenet_pretrain_2x1024_512", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps_cluster.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231", "library_ms": None,
         **data["kernels"]["shapenet_pretrain"]},
    ]
    # every kernel of the paths ran in this run
    for kname in ("fps_cluster", "knn_split", *UPSAMPLE):
        row = next(r for r in kernels if r["name"] == kname)
        check(row["launches"] > 0, f"{kname}: no launch on the main paths")
    log("done")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
