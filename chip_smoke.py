#!/usr/bin/env python3
"""Smoke run of the PyTorch port (witw_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises:
1. Require a CUDA device; print the card's name and power limit.
2. Build all eight CUDA libraries from witw_tpu_torch/csrc with nvcc
   (sm_90a), one nvcc per source started together; print the build seconds
   and the fused match's ptxas register/shared-memory use, failing on any
   spill, and its SASS HGMMA (tf32 wgmma) count, failing where it is 0.
3. Hold the kernel against its plain PyTorch version in f32 (TF32 off) at
   the main-path, fov-90, ragged and gallery-block shapes, and at the card
   tests' edges at full size: hc 6 and 20, sw = W = 100, sw 1, G odd,
   values scaled by 1e3, exact ties between shifts i and i + W / 2 (the
   lower index must win), a NaN in one gallery map (orient and d as the
   plain version's), hc 128 and W 128 and 256 (the kernel's channel chunks),
   W 2048 at hc 16 with sw 64 (a window of 127 rows, refilled for each of
   32 passes) and sw = W (past sw = 1720 the columns do not fit one window:
   3 windows a pass) and inputs 4 bytes off 16-byte alignment.
4. Drive the slice at full CVUSA width (bf16 towers, whose stride-1 convs
   run on the conv3x3_bf16 kernel; batch 128, random weights from a seed):
   FovPipeline.forward_distance at fov 360 and 90.
5. Retrieval eval: train.loop.test (as test_ranks, which also returns the
   ranks) on 1024 synthetic pairs through the fused kernel. Then two
   reference checks: a small full-geometry batch on the GPU against the same
   pipeline on the CPU, and equal ranks from the fused and FFT evaluators on
   planted embeddings.
6. Time the kernel against the plain version (at the main path's G = Q =
   128 host-launched, as the kernels line's ms and plain_ms, and as device
   time from CUDA graphs, its device_ms and plain_device_ms: the wrapper is
   launch-bound there) beside two bounds (f32
   FLOP / 67 TFLOP/s on the CUDA cores; 3 x the FLOP / 494.7 TFLOP/s, the
   kernel's 3xTF32 on the tensor cores), the 8832-pair planted gallery
   sweep through FovGalleryEvaluator on the fused and the FFT path (equal
   ranks required), the kernel at W = 2048 (32 passes, a window each), and embed+match
   pairs/s.
7. The three static-int8 kernels (int8 conv, 2x2 max pool, fused VGG
   block 2), built in phase 2: print ptxas' lines, failing on any spill of
   the int8 conv (kernel A) or the fused block 2 (kernel C), and the IGMMA
   (s8 wgmma) and IDP.4A counts of each of kernel A's and kernel C's
   functions' SASS (cuobjdump), failing where one has no IGMMA or any
   IDP.4A.
8. Hold each against its plain PyTorch version at every distinct layer
   shape of both int8 towers at full CVUSA geometry, at batch 2 (kernel A
   also with ReLU off) and at the main path's batch 128, plus ragged, odd
   and other-width cases (kernel A: Co 16, 20 and 72, Cin 5 and 40, stride
   2 on a 16 x 16 tile, the dequant epilogue at N 64; kernel C: tile tails
   and tiny widths, [1, 17, 33], [2, 16, 16], [1, 2, 2], [3, 9, 3], zero and
   circular, and tables that take its int-to-float requant): int8 outputs
   equal, f32 within 1e-6.
9. The static-int8 serving path at full width: calibrate both towers on 8
   preprocessed samples (as bench.py), then batch 128 raw ->
   preprocess_static_int8 -> both int8 towers -> the fused match, at fov 360
   and 90. Then check_saturation on a held-out batch, int8 against f32
   towers (cosine > 0.99), and the card against the CPU plain path on 2
   samples (embeddings within 1e-6).
10. Time int8 embed+match pairs/s and each int8 kernel against its plain
   version at the main path's shapes (batch 128); kernel A per conv of the
   surface tower (ms, TOP/s, bound) and summed; kernel C also beside the
   unfused composition of the same block (kernel A for conv2_1, kernel A for
   conv2_2, kernel B), whose output must equal kernel C's.
11. The bf16 conv + bias + ReLU kernel (conv3x3_bf16, built in phase 2):
   print ptxas' lines, failing on any spill, and the HGMMA (wgmma) and HMMA
   (mma.sync) counts of each of its kernels' SASS (cuobjdump), failing where
   a kernel has no HGMMA.
12. Hold it against its plain PyTorch version at every distinct conv shape
   of both bf16 towers at full CVUSA geometry (fov 360 and 90, zero and
   circular, as the towers run it and with ReLU flipped at batch 2) at batch
   2, 64 and 128, plus ragged cases and the tiling's edges (W 16 and 66, Co
   16 and 72, Cin 40, circular at W < 64): every output within one bf16 ulp, plus
   the f32 sums' order bound where a sum cancels; print the bit-equal share. Autograd gradients through the kernel against those
   through the plain version at [2, 32, 64, 64] -> 64 (rtol 1e-2).
13. FOV training at full width: train.loop.train on fov_experiment("cvusa",
   360), batch 64, one epoch of 8 train + 2 val steps on synthetic batches,
   with a checkpoint directory. Then: losses finite, the loss falling over 8
   steps on one repeated batch, frozen params bit-unchanged and every
   trainable one moved, `latest` restoring to the saved tensors, and the
   trained bf16 towers on the card (kernel) against the CPU (plain) on 2
   full-geometry samples.
14. Timing: train-step pairs/s at batch 64, and per conv shape of the
   towers at batch 128 the kernel's ms and TFLOP/s beside its plain
   version's, the library call's (torch.cudnn_convolution_relu, or F.conv2d
   without ReLU) and the bound max(FLOP / 989 TFLOP/s, bytes / 3.35 TB/s).
15. The int8 profiling harness's kernels (conv_like, the mma.sync rate
   probe, the layout probes; built in phase 2): print ptxas' lines and the
   IDP.4A count of each conv_like mode's SASS (cuobjdump), failing where a
   stripped mode issues fewer than full.
16. Hold each against its plain PyTorch version: conv_like full bit-equal at
   the probe shape [32, 64, 256] x 128 -> 128 and at a ragged one, its
   stripped modes all zero; mm bit-equal at N 128 and 512, reps 1 and 2048
   (the int32 sum wraps); mmf bit-equal at reps 1 and within
   1024 * 2^-24 * max|y| at reps 1024 (the kernel sums each rep's dot in
   another order), and bit-equal at reps 1 without its whole-dot pass;
   t1-t4 bit-equal.
17. The three entry points, witw_tpu_torch.exp.{int8_isolate,
   int8_mm_probe, mosaic_caps}.run(), each of which must raise the launch
   count of every kernel it reaches; then each kernel timed beside its plain
   version, the library call (cuBLAS: one product's device time, from a
   CUDA graph, x reps for the rate probes; sum, roll and clone for t1, t2,
   t4) and its bound. The layout probes are launch-bound: their kernel,
   plain and library times are all device times from CUDA graphs.
18. FOV serving, building an index: tools.build_index.main on a WITW-schema
   dataset of 512 synthetic 256 x 256 tiles (fov_experiment("witw", 70),
   random weights from a seed saved by the Checkpointer as `best`), in bf16
   and with --int8, --meta-cols col0:x,col1:y. Each build must launch its
   kernels (conv3x3_bf16; kernels A, B and C), stamp precision, the weights
   fingerprint and the coordinates, and its first 8 embeddings must agree
   with the same tiles through the kernels' plain versions on the card
   (bf16 cosine >= 0.999 each; int8 within 1e-6). Prints tiles/s.
19. GalleryIndex at 100,000 tiles [N, 4, 64, 16] (1.64 GB f32, resident
   rFFT table 1.69 GB) with 8 planted queries at sw 64 and 12: search(k=10)
   and resident score_all against streamed score_all's numpy top-10
   (indices and orientations equal, distances within 1e-5),
   search_approx(candidates=256) and fast=True top-1 on the planted rows;
   ms per call at Q 1 and 8 (CUDA events) and the peak device memory.
20. The daemon: GeolocateService(max_batch 8) behind serve() on
   127.0.0.1:0, on [18]'s bf16 index and then with --int8 on its int8
   index: warmup, then 32 POST /geolocate?k=5 of PNG photos, 8 at a time,
   one candidates=64 request, /healthz and /stats. Every answer must equal
   an index.search of the embeddings the daemon computed for that photo's
   group (tiles, orientations, distances, coordinates), those embeddings
   must agree with the same photos through the surface tower with the
   kernels' plain versions on the card (bf16 cosine >= 0.999 each; int8,
   with the daemon's tables, within 1e-6: the bf16 conv and kernels A, B
   and C at the 128 x 99 photo's widths, non-circular), and the right
   kernels must launch. Prints requests/s and p50 / p99 latency.

21. The heatmap sweep: tools.heatmap.main at the CLI's defaults (edge 225 m,
   offset 56.25 m) over bounds that give a 100 x 100 grid, 10,000 tiles of
   750^2 px resampled to 256^2, cut from a synthetic 3-band uint8 strip at
   0.3 m per pixel (about 19,500^2 px, 1.1 GB, written uncompressed into
   .smoke_heatmap/ and removed at the end), 2 photos, fov_experiment("witw",
   70) with random weights from a seed saved as `best`: bf16 cold then warm
   (a cache hit), then --int8 against the bf16 cache (stale by precision:
   rebuilt) cold then warm. Each run must launch its kernels (conv3x3_bf16;
   kernels A, B and C) and not the fused match; the CSV has 2 x 10,000 rows
   under witw_tpu's header, score = exp(10 (1 - d)), warm rows == cold rows;
   the cache's first 8 embeddings agree with the same tiles through the
   kernels' plain versions (bf16 cosine >= 0.999 each; int8 within 1e-6);
   photo 0's dissimilarity and orientation on every tile equal
   index.score_all of its embedding. Prints cold tiles/s (arguments to CSV,
   host clock), the warm seconds, score_all's ms at 10,000 tiles (CUDA
   events) and peak device memory.
22. The training CLI: cli.cvig_fov.main --dataset cvusa --fov 360 (full
   width, batch 64) on 640 synthetic pairs (val_quantity 128 by wrapping
   run_train: 8 train and 2 val steps), --mode train --epochs 1, then
   --mode test, then --mode test --fast-eval, in .smoke_cli/ (removed at
   the end). Losses finite, best.pt and latest.pt written, the metrics
   JSONL holds witw_tpu's records, test mode's metrics == loop.test on the
   restored best, --fast-eval's top-1 == the fused path's on planted
   embeddings; train and test launch conv3x3_bf16, test the fused match,
   --fast-eval and train not. Prints the CLI's train pairs/s beside [14]'s
   staged-batch rate.

23. SAFA towers and ranks at full CVUSA geometry (safa_experiment("cvusa",
   360): 128 x 512 surface, 256^2 tile polar-mapped to 128 x 512; random
   weights from a seed): SafaPipeline.embed_step at batch 128 in bf16
   (conv3x3_bf16) against the same towers under plain_kernels() (rtol 2e-2,
   atol 2e-2 max|y|, unit norms), then both static-int8 towers (calibrated on
   8 preprocessed samples; kernels A, B, C and conv4_3 on kernel A's dequant
   epilogue at Co 512) against plain_kernels() (atol 1e-6) and against the
   f32 towers (cosine > 0.99). euclidean_ranks on 8832 planted
   integer-lattice pairs at D = 4096 (exact in f32) equal to an f64 numpy
   oracle, with the global TF32 flag set True around the call and every
   product seen running with TF32 off. Prints embed+match pairs/s in bf16 and
   int8 (both towers, then the squared distances) and the sweep's seconds.
24. SAFA serving at safa_experiment("witw", 70): build_index.main --family
   safa on [18]'s 512 tiles, bf16 and --int8 (VectorIndex [512, 4096], meta,
   first 8 embeddings against the plain kernels); a VectorIndex of 100,000
   planted integer-lattice vectors (1.64 GB, resident): search(k=10) and
   score_all against an f64 numpy oracle (indices equal, ties to the lower
   index), with times and peak memory; GeolocateService(family="safa",
   max_batch 8) behind serve() in bf16 and --int8, 16 PNG requests from 8
   clients each equal to VectorIndex.search of the daemon's embeddings
   (orientation null), those embeddings against the plain kernels, one
   candidates=64 request searched exactly; heatmap.main --family safa on a
   50 x 50 grid (2,500 tiles) of a synthetic strip in .smoke_safa/, bf16
   then --int8, each cold and warm (CSV without orientation, warm == cold,
   the cache's first 8 embeddings against the plain kernels, photo 0's rows
   == VectorIndex.score_all).
25. cli.cvig_safa.main --dataset cvusa --fov 360 (batch 32) on 320
   synthetic pairs (val_quantity 64 by wrapping run_train: 8 train and 2 val
   steps), --mode train --epochs 1 then --mode test, in .smoke_safa/: losses
   finite, best.pt and latest.pt, no embedding dump, test mode's metrics ==
   loop.test on the restored best (euclidean_ranks); conv3x3_bf16 launched,
   the fused match not.

26. The baseline family at full CVUSA width (baseline_experiment("cvusa"):
   224 x 1232 surfaces, rows repeated to 448 x 1232 on the card, raw 750^2
   tiles, batch 16, random weights from a seed; cuDNN convs): the synced
   rotation card against CPU (surfaces equal, rotated tiles equal but at
   rounding ties), the f32 towers (TF32 off) card against CPU on the same 2
   preprocessed samples (rtol 1e-4, atol 1e-5), the bf16 towers against f32
   (cosine >= 0.999 per row), 4 train steps (losses finite, every BatchNorm
   buffer moved), bf16 embed+match and train-step pairs/s (CUDA events), and
   euclidean_ranks at 8832^2, D 1536, on planted integer-lattice pairs
   against the f64 oracle.
27. The baseline static-int8 towers (im2col of strided views +
   torch._int_mm, f32 epilogue), calibrated on 8 preprocessed samples:
   against f32 on them (cosine > 0.99, pseudo-norm within rtol 0.05,
   saturation < 1%), card against CPU on 2 samples (every layer's int32
   accumulators equal, embeddings within rtol 1e-5, atol 1e-6) and on a WITW
   500^2 photo at batch 1 (conv7's GEMM at M = 1, padded to 17 rows), int8
   embed+match pairs/s; then a device profile (torch.profiler, 4 steps) of
   one bf16 and one int8 embed+match step at batch 16: each stage's device
   time by outermost PyTorch op, grouped as the cuDNN convs, the BatchNorm /
   LeakyReLU / GeM passes, the rotation gather, im2col, torch._int_mm and
   the epilogue.
28. Baseline serving and CLI at baseline_experiment("witw") (500^2 photos,
   raw 750^2 tiles), random weights from a seed saved as `best`:
   build_index.main --family baseline on [18]'s 512 tiles (resized to
   750^2) in bf16 and --int8 (VectorIndex [512, 1536], meta, the first 8
   vectors against the tower on the same tiles); a 100,000 x 1536
   VectorIndex of planted lattice vectors against an f64 oracle, with times
   and peak memory; the daemon (family "baseline", max_batch 8) in bf16 and
   --int8, 16 PNG requests from 8 clients each equal to VectorIndex.search
   of the daemon's embeddings, score exp(-d); heatmap.main --family
   baseline on a 50 x 50 grid (2,500 tiles of 750^2) of a synthetic strip in
   .smoke_baseline/, bf16 then --int8, each cold and warm (score exp(-d),
   warm == cold, photo 0's rows == VectorIndex.score_all); cli.cvig_baseline
   --dataset witw (batch 16) on 160 synthetic pairs (val 32 by wrapping
   run_train), --mode train --epochs 1 then --mode test (== loop.test on the
   restored best). Prints each step's rate.

29. The single-device remainder at fov_experiment("cvusa", 360), random
   weights from a seed: (a) both towers saved as .pth files in the
   reference's wrapped layout (model.features.N.layer.*) and in
   torchvision's (features.N.*, the head at 23 / 25 / 27), read back by
   models.convert_torch and through its CLI's npz (every array equal to the
   source), and the bf16 towers on them (conv3x3_bf16) bit-equal to the
   source towers' embeddings at batch 128; (b) the four presets through
   configs.serialize (the port's own YAML writer and reader; no PyYAML);
   (c) the dynamic-int8 towers (quantize_pipeline, quantized_fov_forward)
   at batch 128 -> the fused match: kernel A launched once per conv of both
   towers (26) and the fused match once, nothing else, and in that same run
   every conv's kernel A output bit-equal to conv3x3_int8_dequant_plain on
   the same int8 input and device-computed dequant vector; cosine per
   embedding against the f32 towers (cuDNN, TF32 off) > 0.99; embed+match pairs/s
   beside bf16's (CUDA events, median of 5 runs of 4 steps), and the
   towers' device time by torch.profiler into kernel A, the abs-max and
   quantize passes, the pools, the ReLU passes and the rest; (d) an async
   Checkpointer (keep 2) through 3 save_steps of the full-width train state
   and a restore_latest, in .smoke_remainder/ (removed at the end).
30. Gallery and query sharding over make_mesh(devices=[cuda:0, cuda:0]) (the
   one card named twice: two shards on it, no speed-up claimed), each
   result against its single-device call in the same run: (a)
   loop.test_ranks(mesh=) at fov_experiment("cvusa", 360), random weights
   from a seed: 1001 planted pairs with the towers tied, in batches of 128
   (a straggler of 105, padded over the data axis), then 1024 random pairs
   in whole batches (ranks spread over the gallery), the query-axis and the
   gallery-resident sweep through the fused match: equal ranks, and
   embed_all(mesh=)'s embeddings against one device's (the whole batches'
   rows, the straggler's beside one device's own batch-53 against
   batch-105 difference); (b) [6]'s 8832-pair planted sweep,
   both shardings, fused and FFT: equal ranks, the shards' placement; (c)
   euclidean_ranks(mesh=) over 8832^2 lattice pairs at D 4096 and 1536;
   (d) GalleryIndex at 100,000 tiles: search_sharded and score_all_sharded
   against search and score_all (top-10 indices and orientations equal,
   distances within rtol 1e-5, atol 1e-6); (e) VectorIndex at 100,000 x
   4096 and x 1536 lattice vectors, bit for bit; (f) GeolocateService(mesh=)
   on [18]'s indexes in bf16 and --int8, 16 photos answered as the
   unsharded service answers them, sharded_devices 2, its embeddings
   against the plain kernels; (g) [21]'s strip swept warm with
   heatmap.sweep(mesh=) on its --int8 cache: the CSV of [21]'s warm sweep
   (photo, x, y and orientations equal, distances within rtol 1e-5, atol
   1e-6). Every check runs and is logged, the phase failing at the end if
   any failed; host-clock times beside the card's name and power limit.
31. Data-parallel training and the multi-process runtime at
   fov_experiment("cvusa", 360), bf16, random weights from a seed, on
   make_mesh(devices=[cuda:0, cuda:0]) (the card named twice): (a) in one
   process, the DP train step (pipeline.train_step on the GlobalBatch of
   loop.device_prefetch(mesh=)) at batch 64 and on a straggler of 63 against
   one device's step from the same state and generator (loss within rtol
   1e-3; each tower's first-step gradient at cosine >= 0.999, norm ratio
   within 1e-2 of 1, a planted fault (per-shard losses, plain DDP's)
   failing the same check), the staged step's ms on both (CUDA events),
   loop.train(mesh=) for one epoch (4 train steps of 64, 1 val step)
   against loop.train on one device (params within rtol 1e-3 + 2.5 lr a
   step, the best val loss within rtol 1e-3), then loop.test(mesh=) on the
   DP-trained towers (tied) over 1001 planted pairs (ranks equal); (b) two
   processes of this script (--dp-worker, Gloo, both on cuda:0, a port from
   the OS, a timeout of their own), each passing its 32 rows of the
   batch-64 step to global_batch_from_local: the step against (a)'s one
   device (same tolerances), params and Adam moments identical on both,
   the gallery-resident and query-split fused-match ranks on 1024 planted
   pairs and GalleryIndex.search_sharded against one device's, a checkpoint
   round trip and a restore_latest broadcast from per-process directories
   (max |diff| 0.0), and (c)'s f32 steps over the two processes; (c) the
   baseline's DP step (baseline_experiment("cvusa"), a straggler of 15:
   global BatchNorm) and SAFA's (batch 32) against one device's, in f32
   (TF32 off; held as (a)) and bf16 (DP_BF16_LIMIT's cosine), each with the
   planted fault failing, and SAFA's f32 gradient split into its shards'
   shares, rounded to bf16 before and after their sum. Work files in
   .smoke_dp/, removed. Every check runs and is
   logged, the phase failing at the end if any failed.
32. Dataset construction and the parity harness (the dataset tools run on
   the card): (a) a synthetic 8-band uint16 strip of 8192 x 8192 (1 GiB) in
   EPSG:4326 near Paris at ~0.3 m, its top 1000 rows nodata, written by
   write_tiff_u16 (uncompressed, struct-packed); (b) convert_8bit on the
   card with the wv3_psms bands (5, 3, 2), Mpx/s; (c) reproject_to_utm to
   EPSG:32631 at 0.3 m on the card, output Mpx/s; (d) (b) on a 1024^2 crop
   and (c)'s warp on one 512^2 output block on the CPU: (lo, hi) and the
   converted uint8 equal, the reprojected uint8 within 1 on at most 1e-4
   of the pixels; (e) build_dataset.build on 512 planted photos (paris and
   rotterdam on the reprojected strip: grey, dark ones a Linear indoor
   classifier saved as a full module drops, preset ids, geotags off the
   strip, tiles over the nodata rows, and 235 a city that stay): the row
   counts of each stage, tiles/s for clipping, each stage's wall time; (f)
   precompute_masks on the clipped 750^2 tiles with the heuristic and a
   Conv2d(3, 1) checkpoint, tiles/s, the heuristic on 8 tiles within atol
   2e-4 of its CPU path; (g) the built train.csv through PairLoader at
   fov_experiment("witw", 70) and one batch embedded by FovPipeline; (h)
   tools.parity.run_parity at fov_experiment("cvusa", 360), bf16, on 256
   synthetic pairs with reference-layout .pth towers: its metrics equal
   loop.test's on the converted towers, the recall@1 gate PASS against
   its own metrics and FAIL against top_1 + 1 pt. Work files in
   .smoke_dataset/, removed. Every check runs and is logged, the phase
   failing at the end if any failed.

The launch counts are reset just before the path they count and read right
after it: the fused match's and the conv kernel's before phase 4 and after
test() in phase 5 (forward_distance at fov 360 and 90, and test(), must each
raise both); all four int8-path kernels' before the int8 path of phase 9 and
after it (its fov 360 and 90 runs must each raise every count); the conv
kernel's before the training of phase 13 and after it (its train and val
phases must each raise it); the probes' before phase 17 and after it; the
conv kernel's (bf16) and kernels A, B and C's (int8) before each index build
of phase 18, each daemon's 32 requests of phase 20 and each sweep of phase 21,
read after each (the records' `serving_launches` sum them); the conv
kernel's and the fused match's before each CLI run of phase 22, read after
each (their records' `cli_launches` sum them); the conv kernel's before the
bf16 SAFA towers of phase 23 and kernels A, B and C's before its int8
towers, and each kernel's before each build, daemon and sweep of phase 24
and each CLI run of phase 25, read after each (the records'
`safa_launches` sum them); every kernel's before each step of phases 26-28,
which must launch none of them (the records' `baseline_launches`, 0); every
kernel's before the dynamic-int8 embed+match of phase 29, read after it
(the records' `dynamic_launches`: kernel A's and the fused match's), the
conv kernel's around the converted towers' runs (`convert_launches`), and
every kernel's before each sharded run of phase 30 (embed_all, both
loop.test sweeps, the four 8832-pair sweeps, each daemon's 16 requests, the
sweep), read after each, which must raise the kernels that path runs (the
records' `sharded_launches` sum them); the fused match's and the conv
kernel's before each DP step, train(mesh=) and loop.test(mesh=) of phase 31,
read after each, plus the counts its two worker processes report (the
records' `dp_launches` sum them); every kernel's before the first
run_parity of phase 32, read after it, which must raise the conv kernel's
and the fused match's (the records' `parity_launches`). The
second-to-last line is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Without a GPU, or without the repo beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import csv
import dataclasses
import importlib.util
import io
import itertools
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from witw_tpu_torch.cli import common as cli_common
from witw_tpu_torch.cli import cvig_baseline, cvig_fov, cvig_safa
from witw_tpu_torch.configs import (baseline_experiment, fov_experiment, safa_experiment,
                                    semantic_experiment, serialize)
from witw_tpu_torch.data import loader, synthetic
from witw_tpu_torch.data.csv_registry import read_pair_paths
from witw_tpu_torch.evaluation import gallery
from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator, metrics_from_ranks
from witw_tpu_torch.evaluation.index import GalleryIndex
from witw_tpu_torch.evaluation.vector_index import VectorIndex
from witw_tpu_torch.exp import int8_isolate, int8_mm_probe, mosaic_caps
from witw_tpu_torch.kernels.build import build_libraries, nvcc_path
from witw_tpu_torch.match.correlation import circular_correlation
from witw_tpu_torch.match.losses import pairwise_sq_distances
from witw_tpu_torch.models import convert_torch, quantize
from witw_tpu_torch.models.backbones import vgg16
from witw_tpu_torch.models.baseline import BaselineEncoder
from witw_tpu_torch.models.backbones.vgg16 import VGG16_BLOCKS
from witw_tpu_torch.models.fov_dsm import HEAD_CONVS, FovDsm
from witw_tpu_torch.models.safa import VggSafa
from witw_tpu_torch.ops import conv3x3, fused_block2, fused_match, int8_conv, maxpool, rotation
from witw_tpu_torch.ops.image import normalize_images
from witw_tpu_torch.ops.polar import polar_transform
from witw_tpu_torch.parallel import make_mesh
from witw_tpu_torch.tools import (build_dataset, build_index, convert_8bit, geotiff, heatmap, parity,
                                  reproject, semantic_masks)
from witw_tpu_torch.tools.cities import strip_filename
from witw_tpu_torch.tools import serve as serve_tool
from witw_tpu_torch.train import loop
from witw_tpu_torch.train.checkpoint import Checkpointer
from witw_tpu_torch.train.pipeline import BaselinePipeline, FovPipeline, SafaPipeline, TrainState
from witw_tpu_torch.utils.device import require_cuda
from witw_tpu_torch.utils.hashing import params_fingerprint
from witw_tpu_torch.utils.profiling import cuda_ms, graph_ms

T_START = time.perf_counter()
RTOL, ATOL = 1e-5, 1e-6
TIE_REL = 1e-5  # plain top-2 correlation gap under which a pair is a near tie
KERNEL_SOURCE = "witw_tpu_torch/csrc/fused_match.cu"
KERNEL_REPLACES = "witw_tpu/ops/pallas/fused_match.py:83"
PROBE_LIBRARIES = ["conv_like", "mm_probe", "caps"]
LIBRARIES = ["fused_match", "int8_conv", "maxpool", "fused_block2", "conv3x3_bf16"] + PROBE_LIBRARIES
# Published peaks of one H100 SXM (dense, at 700 W) for the bound_ms column.
PEAK_BYTES_PER_MS = 3.35e9          # 3.35 TB/s
PEAK_F32_PER_MS = 67e9              # CUDA cores
PEAK_TF32_PER_MS = 494.7e9          # tensor cores
PEAK_BF16_PER_MS = 989e9            # tensor cores
PEAK_INT8_PER_MS = 1979e9           # tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(ops: float, nbytes: float, peak_ops_per_ms: float):
    """(least ms, what bounds it): the larger of operations over the peak
    rate and bytes (each input read once, each output written once) over
    the memory rate."""
    t_ops, t_bytes = ops / peak_ops_per_ms, nbytes / PEAK_BYTES_PER_MS
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def print_ptxas(build_log: str) -> None:
    for line in build_log.splitlines():
        if "ptxas info" in line or "spill" in line:
            log("    " + line.strip())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def maps(gen, g, q, h, w, c, sw, device):
    o = torch.randn(g, h, w, c, generator=gen, device=device)
    s = torch.randn(q, h, sw, c, generator=gen, device=device)
    return o, s


def compare_kernel(name, o, s, data="random"):
    """Kernel vs plain on the same inputs; near-tie pairs (plain top-2 gap
    <= TIE_REL * |max|) are excluded, every other pair must agree. ``data``
    "tie": gallery maps of period W / 2, whose shifts i and i + W / 2 tie
    exactly (the top-3 gap decides, and the lower index must win); "nan":
    gallery map 2 holds a NaN (its row must match the plain version's: the
    first NaN shift and d NaN)."""
    d_k, or_k = fused_match.fused_chord_distance_nhwc(o, s)
    d_p, or_p = fused_match.fused_chord_distance_plain(o, s)
    top = torch.topk(circular_correlation(o, s), 3 if data == "tie" else 2, dim=-1).values
    tie = ~((top[..., 0] - top[..., -1]) > TIE_REL * top[..., 0].abs())
    torch.cuda.synchronize()
    keep = ~tie
    orient_bad = int(((or_k != or_p) & keep).sum())
    err = (d_k - d_p).abs()[keep]
    max_abs = float(err.max()) if err.numel() else 0.0
    close = torch.isclose(d_k, d_p, rtol=RTOL, atol=ATOL) | tie
    others = torch.arange(o.shape[0], device=o.device) != 2 if data == "nan" else slice(None)
    ok = bool(d_k[others].isfinite().all())
    extra = ""
    if data == "tie":
        lowest = bool((or_k < o.shape[2] // 2).all())
        ok = ok and lowest
        extra = f"  lowest_index_won={lowest}"
    elif data == "nan":
        nan_row = bool(torch.equal(or_k[2], or_p[2]) and d_k[2].isnan().all() and d_p[2].isnan().all())
        ok = ok and nan_row
        extra = f"  nan_map_orient_and_d_as_plain={nan_row}"
    log(f"  {name}: G={o.shape[0]} Q={s.shape[0]} h={o.shape[1]} W={o.shape[2]} "
        f"c={o.shape[3]} sw={s.shape[2]}  max_abs_err={max_abs:.3e}  "
        f"near_ties_excluded={int(tie.sum())}/{tie.numel()}  orient_mismatch={orient_bad}{extra}")
    if orient_bad or not bool(close.all()) or not ok:
        raise AssertionError(f"kernel disagrees with its plain version at {name}")
    return max_abs


def interleaved_ms(plain, kernel, calls: int, reps: int):
    """Plain and kernel timed in turns (plain, kernel, kernel, plain, ...)."""
    t_plain, t_kernel = [], []
    for rep in range(reps):
        order = [(plain, t_plain), (kernel, t_kernel)]
        for fn, out in (order if rep % 2 == 0 else order[::-1]):
            out.append(cuda_ms(fn, calls, 1))
    return statistics.median(t_kernel), statistics.median(t_plain)


def raw_batch(rng, cfg, b):
    d = cfg.data
    return {
        "surface": rng.uniform(0, 255, (b, d.surface_height, d.surface_width_max, 3)).astype(np.float32),
        "overhead": rng.uniform(0, 255, (b, d.overhead_size, d.overhead_size, 3)).astype(np.float32),
    }


def synthetic_loader(cfg, n, batch, seed):
    rng = np.random.default_rng(seed)
    d = cfg.data
    for _ in range(n // batch):
        yield {
            "surface": rng.integers(0, 256, (batch, d.surface_height, d.surface_width_max, 3), np.uint8),
            "overhead": rng.integers(0, 256, (batch, d.overhead_size, d.overhead_size, 3), np.uint8),
        }


def planted_embeddings(rng, n, h, w, c, sw):
    """As tests/test_pallas_match.py plants them: each surface is a noisy
    window of its own overhead map."""
    o = rng.standard_normal((n, h, w, c)).astype(np.float32)
    s = rng.standard_normal((n, h, sw, c)).astype(np.float32)
    for i in range(n):
        start = rng.integers(0, w)
        cols = [(start + k) % w for k in range(sw)]
        s[i] = o[i][:, cols, :] + 0.1 * s[i]
    return o, s


# --- static-int8 serving path (phases 7-10) ---------------------------------

INT8_KERNELS = {  # module name: (kernel name, source, TPU kernels it replaces)
    "int8_conv": ("conv3x3_int8", "witw_tpu_torch/csrc/int8_conv.cu",
                  "exp/int8_conv_pallas.py:48, exp/int8_conv_v2.py:38, exp/r4_conv_taps.py:69"),
    "maxpool": ("maxpool2x2", "witw_tpu_torch/csrc/maxpool.cu", "exp/pallas_maxpool.py:30"),
    "fused_block2": ("fused_block2", "witw_tpu_torch/csrc/fused_block2.cu",
                     "exp/fused_block2.py:108, exp/fused_block2_v2.py:190"),
}
INT8_MODULES = {"int8_conv": int8_conv, "maxpool": maxpool, "fused_block2": fused_block2}
INT8_RTOL = INT8_ATOL = 1e-6


def tower_calls(h, w, cin, circ):
    """The kernel calls of one static-int8 tower on an [h, w, cin] input, in
    order: ("conv", (h, w, cin), co, stride_h, pad_w, epilogue),
    ("pool", (h, w, c)) and ("block2", (h, w, 64))."""
    pad = 0 if circ else 1
    calls = []
    for block_i, block in enumerate(VGG16_BLOCKS):
        if block_i == 1:
            calls.append(("block2", (h, w, cin)))
            h, w, cin = h // 2, w // 2, block[-1][1]
            continue
        if circ:
            w += 2 * len(block)
        for _, co in block:
            calls.append(("conv", (h, w, cin), co, 1, pad, "int8"))
            w, cin = w + 2 * pad - 2, co
        if block_i < 3:
            calls.append(("pool", (h, w, cin)))
            h, w = h // 2, w // 2
    if circ:
        w += 2 * len(HEAD_CONVS)
    for i, (_, co, strides, _) in enumerate(HEAD_CONVS):
        calls.append(("conv", (h, w, cin), co, strides[0], pad,
                      "f32" if i + 1 == len(HEAD_CONVS) else "int8"))
        h, w, cin = (h - 1) // strides[0] + 1, w + 2 * pad - 2, co
    return calls


def conv_case(gen, device, b, hwc, co):
    """Random int8 input, packed weights and epilogue tables whose
    requantized outputs spread over the int8 range."""
    h, w, cin = hwc
    acc_std = 3.0 * cin ** 0.5 * 73.3 * 73.3
    k = torch.randint(-127, 128, (co, 3, 3, cin), generator=gen, device=device, dtype=torch.int8)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(co, generator=gen, device=device)

    hwio = k.permute(1, 2, 3, 0).cpu().numpy()
    return {
        "x": torch.randint(-127, 128, (b, h, w, cin), generator=gen, device=device,
                           dtype=torch.int8),
        "w": torch.nn.functional.pad(k, (0, int8_conv.padded_channels(cin) - cin)),
        "w_wgmma": torch.from_numpy(int8_conv.pack_weights_wgmma(hwio)).to(device),
        "bias_q": uniform(-acc_std, acc_std).to(torch.int32),
        "m": uniform(20.0, 60.0) / acc_std,
        "dequant": uniform(1e-5, 1e-4),
        "bias_f": torch.randn(co, generator=gen, device=device),
    }


def run_conv(t, stride_h, pad_w, epilogue, plain=False, relu=True):
    if epilogue == "f32":
        if plain:
            return int8_conv.conv3x3_int8_dequant_plain(t["x"], t["w"], t["dequant"], t["bias_f"],
                                                        stride_h, pad_w)
        return int8_conv.conv3x3_int8_dequant(t["x"], t["w"], t["dequant"], t["bias_f"], stride_h,
                                              pad_w, t["w_wgmma"])
    if plain:
        return int8_conv.conv3x3_int8_plain(t["x"], t["w"], t["bias_q"], t["m"], stride_h, pad_w,
                                            relu)
    return int8_conv.conv3x3_int8(t["x"], t["w"], t["bias_q"], t["m"], stride_h, pad_w, relu,
                                  t["w_wgmma"])


def block2_args(gen, device, b, h, w):
    """Kernel C's positional arguments (x, w1, b1, m1, w2, b2, m2) and its
    weight tables {w1_wgmma, w2_wgmma}."""
    c1 = conv_case(gen, device, b, (h, w, 64), 128)
    c2 = conv_case(gen, device, b, (h, w, 128), 128)
    return ((c1["x"].abs(), c1["w"], c1["bias_q"], c1["m"], c2["w"], c2["bias_q"], c2["m"]),
            {"w1_wgmma": c1["w_wgmma"], "w2_wgmma": c2["w_wgmma"]})


def block2_unfused(x, w1, b1, m1, w2, b2, m2, w1_wgmma, w2_wgmma):
    """Block 2 as three kernels (zero width padding): kernel A for conv2_1,
    kernel A for conv2_2, kernel B for the pool."""
    y1 = int8_conv.conv3x3_int8(x, w1, b1, m1, 1, 1, True, w1_wgmma)
    return maxpool.maxpool2x2(int8_conv.conv3x3_int8(y1, w2, b2, m2, 1, 1, True, w2_wgmma))


def check_equal(name, got, want):
    """Integer outputs equal; float outputs within INT8_RTOL / INT8_ATOL.
    Returns the max abs error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs plain "
                             f"{want.dtype} {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if not got.dtype.is_floating_point:
        ok = torch.equal(got, want)
    else:
        ok = bool(torch.isclose(got.float(), want.float(), rtol=INT8_RTOL, atol=INT8_ATOL).all())
    log(f"  {name}: {tuple(got.shape)} {str(got.dtype).replace('torch.', '')} "
        f"max_abs_err={err:.3e}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version at {name}")
    return err


def int8_distance(data_cfg, sq_s, sq_o, batch):
    """The static-int8 serving forward of bench.py: int8-first preprocessing,
    both int8 towers, the fused match -> d [Bo, Bs]."""
    surf_q, polar_q = quantize.preprocess_static_int8(data_cfg, sq_s, sq_o, batch)
    s_emb = quantize.quantized_fov_forward_static(sq_s, surf_q, False, x_quantized=True)
    o_emb = quantize.quantized_fov_forward_static(sq_o, polar_q, True, x_quantized=True)
    return fused_match.fused_chord_distance_nhwc(o_emb, s_emb)[0]


def cosine(a, b):
    return float((a * b).sum() / (a.norm() * b.norm()))


def int8_phases(card, device, cfg, pipeline, params, built):
    """Phases 7-10; returns the three kernels' JSON records."""
    # 7. the int8 kernels, built in phase 2
    for mod in INT8_MODULES.values():
        mod._lib()
    log(f"[7] {', '.join(built[n][0].name for n in INT8_KERNELS)} (built in phase 2)")
    for name in INT8_KERNELS:
        print_ptxas(built[name][1])
    check_wgmma_build("int8_conv", built, "IGMMA", ("IGMMA", "IDP.4A"), forbidden="IDP.4A")
    check_wgmma_build("fused_block2", built, "IGMMA", ("IGMMA", "IDP.4A"), forbidden="IDP.4A")

    # 8. each kernel against its plain version at every layer shape of the
    # towers, at batch 2 and at the main path's batch 128
    d = cfg.data
    log(f"[8] static-int8 kernels vs plain PyTorch, batch 2 and 128 at full CVUSA geometry "
        f"(int8 equal; f32 rtol {INT8_RTOL}, atol {INT8_ATOL})")
    gen = torch.Generator(device=device).manual_seed(7)
    calls = (tower_calls(d.surface_height, d.surface_width_max, 3, False)
             + tower_calls(d.surface_height, d.surface_width_max, 3, True))

    def at_batches(kind, shape_of):
        return list(dict.fromkeys((b,) + shape_of(c) for b in (2, 128)
                                  for c in calls if c[0] == kind))

    err = {name: 0.0 for name in INT8_KERNELS}
    convs = at_batches("conv", lambda c: c[1:])
    convs += [(1, (7, 9, 5), 64, 1, 1, "int8"),  # ragged: B 1, odd H and W, Cin 5
              (2, (9, 11, 40), 20, 1, 1, "int8"),  # Co 20 (4-byte stores), Cin 40
              (2, (16, 21, 64), 72, 1, 0, "int8"),  # Co 72: a channel tile's tail
              (3, (17, 35, 128), 256, 2, 1, "int8"),  # stride 2 on a 16 x 16 tile
              (1, (5, 6, 512), 16, 1, 1, "int8"),  # Co 16 with the int8 epilogue
              (2, (8, 20, 64), 64, 1, 1, "f32")]  # the dequant epilogue at N 64
    for b, hwc, co, sh, pad, ep in convs:
        t = conv_case(gen, device, b, hwc, co)
        for relu in ((True, False) if b <= 3 and ep == "int8" else (True,)):
            e = check_equal(f"conv3x3_int8 B={b} HWC={hwc} Co={co} stride_h={sh} pad_w={pad} {ep}"
                            f"{'' if relu else ' relu=False'}", run_conv(t, sh, pad, ep, relu=relu),
                            run_conv(t, sh, pad, ep, plain=True, relu=relu))
            err["int8_conv"] = max(err["int8_conv"], e)
        del t
    for shape in at_batches("pool", lambda c: c[1]) + [(1, 7, 9, 6), (2, 33, 65, 64)]:
        for dtype in (torch.int8, torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device=device) * 40).round().clamp(-127, 127)
            x = x.to(dtype)
            e = check_equal(f"maxpool2x2 {shape}", maxpool.maxpool2x2(x),
                            maxpool.maxpool2x2_plain(x))
            err["maxpool"] = max(err["maxpool"], e)
    block2_shapes = at_batches("block2", lambda c: c[1][:2]) + [
        (2, 64, 100), (1, 31, 45),  # ragged
        (1, 17, 33), (2, 16, 16), (1, 2, 2), (3, 9, 3)]  # tile tails and tiny widths
    for b, h, w in block2_shapes:
        args, tables = block2_args(gen, device, b, h, w)
        for circ in (False, True):
            e = check_equal(f"fused_block2 B={b} H={h} W={w} circular={circ}",
                            fused_block2.fused_block2(*args, circular=circ, **tables),
                            fused_block2.fused_block2_plain(*args, circular=circ))
            err["fused_block2"] = max(err["fused_block2"], e)
    # tables outside the range of kernel C's conversion-free requant take its
    # int-to-float requant
    (x, w1, b1, m1, w2, b2, m2), tables = block2_args(gen, device, 2, 64, 256)
    m1 = m1.clone()
    m1[0] = 1e-6
    for circ in (False, True):
        e = check_equal(f"fused_block2 B=2 H=64 W=256 circular={circ}, m1[0] 1e-6 (exact requant)",
                        fused_block2.fused_block2(x, w1, b1, m1, w2, b2, m2, circ, **tables),
                        fused_block2.fused_block2_plain(x, w1, b1, m1, w2, b2, m2, circ))
        err["fused_block2"] = max(err["fused_block2"], e)

    # 9. the int8 serving path at full width (random weights from phase 4)
    log("[9] static-int8 serving path: calibrate on 8 preprocessed samples, then batch 128 "
        "raw -> preprocess_static_int8 -> int8 towers -> fused match")
    batch = raw_batch(np.random.default_rng(4), cfg, 128)
    calib = {k: v[:8] for k, v in batch.items()}
    s_in, p_in = pipeline.preprocess(calib)
    t0 = time.perf_counter()
    sq_s, sq_o = quantize.quantize_pipeline_static(params, [(s_in, p_in)])
    torch.cuda.synchronize()
    log(f"    calibrated both towers in {time.perf_counter() - t0:.2f} s")
    counted = dict(INT8_MODULES, fused_match=fused_match)
    for mod in counted.values():
        mod.launches = 0
    cfg90 = fov_experiment("cvusa", 90)
    dists = {}
    for fov, c in ((360, cfg), (90, cfg90)):
        before = {n: m.launches for n, m in counted.items()}
        dists[fov] = int8_distance(c.data, sq_s, sq_o, batch)
        torch.cuda.synchronize()
        dd = dists[fov]
        if dd.shape != (len(batch["surface"]),) * 2 or not bool(torch.isfinite(dd).all()):
            raise AssertionError(f"int8 fov {fov} distances: shape {tuple(dd.shape)}, finite "
                                 f"{bool(torch.isfinite(dd).all())}")
        idle = [n for n, m in counted.items() if m.launches <= before[n]]
        if idle:
            raise AssertionError(f"int8 fov {fov} path did not launch {idle}")
    launches = {n: m.launches for n, m in counted.items()}
    log(f"    int8 batch 128: fov 360 d [128, 128] mean {float(dists[360].mean()):.6f}; "
        f"fov 90 d [128, 128] mean {float(dists[90].mean()):.6f}; launches {launches}")

    # Checks past this point launch the kernels outside the counted path.
    held = pipeline.preprocess(raw_batch(np.random.default_rng(5), cfg, 8))
    sat_s = quantize.check_saturation(sq_s, held[0], False, "surface")
    sat_o = quantize.check_saturation(sq_o, held[1], True, "overhead")
    log(f"    check_saturation on a held-out batch of 8: surface {sat_s:.6f}, "
        f"overhead {sat_o:.6f} (warns above {quantize.SATURATION_WARN_FRACTION})")
    f32_model = dataclasses.replace(cfg.model, compute_dtype="float32")
    for tower, circ, x, sq in (("surface", False, s_in, sq_s), ("overhead", True, p_in, sq_o)):
        model = FovDsm(f32_model, circ_padding=circ).to(device).eval()
        with torch.no_grad():
            want = functional_call(model, params[tower], (x,), strict=True)
        cos = cosine(quantize.quantized_fov_forward_static(sq, x, circ), want)
        log(f"    int8 vs f32 {tower} tower on the 8 calibration samples: cosine {cos:.6f} (> 0.99)")
        if not cos > 0.99:
            raise AssertionError(f"int8 {tower} tower disagrees with the f32 tower")
    two = {k: v[:2] for k, v in batch.items()}
    inputs = quantize.preprocess_static_int8(cfg.data, sq_s, sq_o, two)
    for tower, circ, xq, sq in (("surface", False, inputs[0], sq_s),
                                ("overhead", True, inputs[1], sq_o)):
        gpu = quantize.quantized_fov_forward_static(sq, xq, circ, x_quantized=True).cpu()
        cpu = quantize.quantized_fov_forward_static(
            quantize.static_qparams_to_device(sq, "cpu"), xq.cpu(), circ, x_quantized=True)
        e = float((gpu - cpu).abs().max())
        log(f"    {tower} tower, 2 samples at full geometry: GPU (kernels) vs CPU (plain) "
            f"max |d emb| = {e:.3e} (atol 1e-6)")
        if not e <= 1e-6:
            raise AssertionError(f"int8 {tower} tower: GPU disagrees with CPU")

    # 10. timing (CUDA events, warm, median of >= 5)
    log(f"[10] static-int8 timing on {card}")
    gen_in = torch.Generator(device=device).manual_seed(11)
    staged = [
        {"surface": torch.rand(128, d.surface_height, d.surface_width_max, 3,
                               generator=gen_in, device=device) * 255.0,
         "overhead": torch.rand(128, d.overhead_size, d.overhead_size, 3,
                                generator=gen_in, device=device) * 255.0}
        for _ in range(4)
    ]
    step_of = iter(range(10**9))

    def stage(fn):
        return lambda: fn(staged[next(step_of) % len(staged)])

    def embed(b):
        surf_q, polar_q = quantize.preprocess_static_int8(d, sq_s, sq_o, b)
        return (quantize.quantized_fov_forward_static(sq_s, surf_q, False, x_quantized=True),
                quantize.quantized_fov_forward_static(sq_o, polar_q, True, x_quantized=True))

    steps = 8
    t_pre = cuda_ms(stage(lambda b: quantize.preprocess_static_int8(d, sq_s, sq_o, b)), steps, 5)
    t_embed = cuda_ms(stage(embed), steps, 5)
    t_fwd = cuda_ms(stage(lambda b: int8_distance(d, sq_s, sq_o, b)), steps, 5)
    log(f"    embed+match static-int8 batch 128 (fov 360, varied inputs): {t_fwd:.3f} ms/step, "
        f"{128 * 1000.0 / t_fwd:.2f} pairs/s; preprocess {t_pre:.3f} ms, embed (incl. "
        f"preprocess) {t_embed:.3f} ms, match {t_fwd - t_embed:.3f} ms ({card})")
    del staged

    surf_convs = [c for c in tower_calls(d.surface_height, d.surface_width_max, 3, False)
                  if c[0] == "conv"]
    # bounds: int8 ops (2 x multiply-adds of the real channels) at the
    # tensor-core rate against bytes (input, packed weights, tables, output)
    a_layers = []
    for _, (h, w, cin), co, sh, pad, ep in surf_convs:
        t = conv_case(gen, device, 128, (h, w, cin), co)
        t_k, t_p = interleaved_ms(lambda: run_conv(t, sh, pad, ep, plain=True),
                                  lambda: run_conv(t, sh, pad, ep), calls=2, reps=5)
        ho, wo = int8_conv.output_hw(h, w, sh, pad)
        ops = 2.0 * 128 * ho * wo * co * 9 * cin
        nbytes = (128 * h * w * cin + co * 9 * int8_conv.padded_channels(cin) + 8 * co
                  + 128 * ho * wo * co * (4 if ep == "f32" else 1))
        t_bound, by = bound(ops, nbytes, PEAK_INT8_PER_MS)
        a_layers.append((t_k, t_p, t_bound, by))
        log(f"    conv3x3_int8 B=128 HWC=({h}, {w}, {cin}) Co={co} stride_h={sh} {ep}: kernel "
            f"{t_k:.4f} ms ({ops / t_k / 1e9:.1f} TOP/s), plain {t_p:.4f} ms, bound "
            f"{t_bound:.4f} ms ({by}) ({card})")
        del t
    t_a, t_a_plain, a_ms = (sum(r[i] for r in a_layers) for i in range(3))
    a_by = max(("operations", "bytes"), key=lambda k: sum(r[2] for r in a_layers if r[3] == k))
    log(f"    conv3x3_int8, the surface tower's {len(a_layers)} kernel-A convs summed, batch 128: "
        f"kernel {t_a:.4f} ms, plain {t_a_plain:.4f} ms, bound {a_ms:.4f} ms ({a_by}) ({card})")
    x = torch.randint(-127, 128, (128, d.surface_height, d.surface_width_max, 64),
                      generator=gen, device=device, dtype=torch.int8)
    t_b, t_b_plain = interleaved_ms(lambda: maxpool.maxpool2x2_plain(x),
                                    lambda: maxpool.maxpool2x2(x), calls=10, reps=5)
    log(f"    maxpool2x2 pool 1 {tuple(x.shape)} int8: kernel {t_b:.4f} ms, "
        f"plain {t_b_plain:.4f} ms ({card})")
    x_pool_numel = x.numel()
    del x
    b, h, w = 128, d.surface_height // 2, d.surface_width_max // 2
    args, tables = block2_args(gen, device, b, h, w)

    def kernel_c():
        return fused_block2.fused_block2(*args, **tables)

    def unfused():
        return block2_unfused(*args, **tables)

    check_equal(f"unfused block 2 (kernel A, kernel A, kernel B) vs kernel C {tuple(args[0].shape)}",
                unfused(), kernel_c())
    t_c, t_c_plain = interleaved_ms(lambda: fused_block2.fused_block2_plain(*args), kernel_c,
                                    calls=2, reps=5)
    t_c2, t_unfused = interleaved_ms(unfused, kernel_c, calls=2, reps=5)
    c_ops = 2.0 * b * h * w * 128 * 9 * (64 + 128)
    c_bytes = b * h * w * 64 + b * (h // 2) * (w // 2) * 128 + 128 * 9 * (64 + 128) + 16 * 128
    c_bound = bound(c_ops, c_bytes, PEAK_INT8_PER_MS)
    log(f"    fused_block2 block 2 {tuple(args[0].shape)}: kernel {t_c:.4f} ms "
        f"({c_ops / t_c / 1e9:.1f} useful TOP/s; {t_c2:.4f} ms beside the unfused run), plain "
        f"{t_c_plain:.4f} ms, unfused (kernel A, kernel A, kernel B) {t_unfused:.4f} ms, bound "
        f"{c_bound[0]:.4f} ms ({c_bound[1]}) ({card})")

    pool_bytes = x_pool_numel * 5 / 4
    bounds = {"int8_conv": (a_ms, a_by), "maxpool": bound(0.0, pool_bytes, PEAK_INT8_PER_MS),
              "fused_block2": c_bound}
    for mod, (t, by) in bounds.items():
        log(f"    {mod} bound {t:.4f} ms ({by}; H100 SXM peaks)")
    times = {"int8_conv": (t_a, t_a_plain), "maxpool": (t_b, t_b_plain),
             "fused_block2": (t_c, t_c_plain)}
    records = [{
        "name": kname, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[mod], "max_abs_err": err[mod],
        "ms": times[mod][0], "plain_ms": times[mod][1],
        "bound_ms": bounds[mod][0], "bound_by": bounds[mod][1], "library_ms": None,
    } for mod, (kname, source, replaces) in INT8_KERNELS.items()]
    records[list(INT8_KERNELS).index("fused_block2")]["unfused_ms"] = t_unfused
    return records


# --- bf16 conv kernel and FOV training (phases 11-14) -------------------------

CONV_SOURCE = "witw_tpu_torch/csrc/conv3x3_bf16.cu"
CONV_REPLACES = "exp/pallas_conv3x3.py:56, exp/pallas_conv3x3.py:151"
GRAD_RTOL = 1e-2  # bf16 backward (cuDNN) against the plain version's f32 backward


def bf16_conv_shapes(h, w, cin, circ):
    """(h, w, cin, co, circular, relu) of each fused conv of a bf16 tower on
    an [h, w, cin] input, in order: the 10 VGG convs and conv_27."""
    shapes = []
    for block_i, block in enumerate(VGG16_BLOCKS):
        for _, co in block:
            shapes.append((h, w, cin, co, circ, True))
            cin = co
        if block_i < 3:
            h, w = h // 2, w // 2
    for _, co, strides, relu in HEAD_CONVS:
        if tuple(strides) == (1, 1):
            shapes.append((h, w, cin, co, circ, relu))
        h, cin = (h - 1) // strides[0] + 1, co
    return shapes


def conv_inputs(gen, device, b, h, w, cin, co):
    x = torch.randn(b, h, w, cin, generator=gen, device=device).to(torch.bfloat16)
    wt = torch.randn(co, cin, 3, 3, generator=gen, device=device) / (9 * cin) ** 0.5
    bias = 0.1 * torch.randn(co, generator=gen, device=device)
    return x, wt.to(torch.bfloat16), bias


def bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at max(|got|, |want|)."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    return (got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_conv(name, x, w, bias, circ, relu):
    """Kernel against plain on the same inputs. Both sum the same f32
    products in different orders, then round once to bf16: each output is
    within one bf16 ulp of the other plus the two sums' worst-case f32 order
    error, 2 n 2^-24 sum |products| (n = 9 Cin terms). That second term
    matters only where the sum cancels to far below the size of its terms;
    elsewhere the bound is one ulp. Returns (max abs error, max ulps,
    bit-equal share, share beyond one ulp)."""
    got = conv3x3.conv3x3_bias_relu_kernel(x, conv3x3.pack_weights(w), bias, circ, relu)
    want = conv3x3.conv3x3_bias_relu_plain(x, w, bias, circ, relu)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs plain "
                             f"{want.dtype} {tuple(want.shape)}")
    ulps = bf16_ulps(got, want)
    diff = (got.float() - want.float()).abs()
    terms = torch.nn.functional.conv2d(
        conv3x3.pad_width(x.float().abs().permute(0, 3, 1, 2), circ), w.float().abs(),
        padding=(1, 0)).permute(0, 2, 3, 1) + bias.abs()
    order = 2.0 * 9 * x.shape[-1] * 2.0 ** -24 * terms
    spacing = diff / ulps.clamp_min(1e-30)
    ok = bool((diff <= torch.where(ulps > 1.0, spacing + order, spacing)).all())
    max_ulps = float(ulps.max())
    beyond = float((ulps > 1.0).float().mean())
    err = float(diff.max())
    equal = float((got == want).float().mean())
    log(f"  {name}: max_abs_err={err:.3e} max_ulps={max_ulps:.3f} bit_equal={equal:.6f} "
        f"beyond_1_ulp={beyond:.2e}")
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"conv3x3_bf16 disagrees with its plain version at {name}")
    return err, max_ulps, equal, beyond


def conv_work(b, h, w, cin, co):
    """(FLOP, bytes) of one conv: 2 x multiply-adds of the real channels;
    bf16 input and output, bf16 weights, f32 bias."""
    return (2.0 * b * h * w * co * 9 * cin,
            2.0 * (b * h * w * (cin + co) + co * 9 * cin) + 4.0 * co)


def library_conv(x, w, bias, relu):
    """One PyTorch call for the same conv on the NCHW channels_last view
    (zero width padding): cuDNN's fused conv + bias + ReLU, or F.conv2d."""
    xn = x.permute(0, 3, 1, 2)
    wn = w.contiguous(memory_format=torch.channels_last)
    if relu and hasattr(torch, "cudnn_convolution_relu"):
        return lambda: torch.cudnn_convolution_relu(xn, wn, bias.to(x.dtype), (1, 1), (1, 1),
                                                    (1, 1), 1)
    return lambda: torch.nn.functional.conv2d(xn, wn, bias.to(x.dtype), 1, 1)


def check_wgmma_build(name, built, mma, opcodes, forbidden=None):
    """Fail on any register spill in ``name``'s ptxas lines, and where a
    kernel function of its SASS holds no ``mma`` instruction (the warpgroup
    MMA: HGMMA for bf16, IGMMA for int8) or any ``forbidden`` one."""
    lines = built[name][1].splitlines()
    if not any("ptxas info" in line for line in lines):
        raise AssertionError(f"{name} has no ptxas report to check (its build log is gone)")
    for line in lines:
        if "warning" in line.lower():
            log("    " + line.strip())
    spills = [line.strip() for line in lines if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
    if spills:
        raise AssertionError(f"{name} spills registers: {spills}")
    counts = sass_counts(built[name][0], opcodes)
    for fn, c in counts.items():
        log(f"    SASS {fn}: {c}")
    if not counts or not all(c[mma] > 0 for c in counts.values()):
        raise AssertionError(f"{name} has a kernel without {mma} (wgmma): {counts}")
    if forbidden and any(c[forbidden] for c in counts.values()):
        raise AssertionError(f"{name} still issues {forbidden}: {counts}")


def conv_phases(card, device, cfg, built):
    """Phases 11-14; returns the conv kernel's JSON record."""
    d = cfg.data
    # 11. the conv kernel, built in phase 2
    log(f"[11] {built['conv3x3_bf16'][0].name} (built in phase 2)")
    print_ptxas(built["conv3x3_bf16"][1])
    check_wgmma_build("conv3x3_bf16", built, "HGMMA", ("HGMMA", "HMMA"))

    # 12. kernel vs plain at every conv shape of both bf16 towers
    log("[12] conv3x3_bf16 vs plain PyTorch at every bf16 tower conv shape, batch 2, 64 and "
        "128, full CVUSA geometry (within one bf16 ulp + the f32 order bound)")
    towers = (bf16_conv_shapes(d.surface_height, d.surface_width_max, 3, False)
              + bf16_conv_shapes(d.surface_height, d.surface_width_max // 4, 3, False)
              + bf16_conv_shapes(d.surface_height, d.surface_width_max, 3, True))
    shapes = list(dict.fromkeys(towers))
    cases = [(b,) + sh for b in (2, 64, 128) for sh in shapes]
    cases += [(2, h, w, cin, co, circ, not relu) for h, w, cin, co, circ, relu in shapes]
    cases += [(1, 7, 9, 5, 24, False, True), (3, 9, 1, 16, 8, True, True),
              (2, 17, 33, 40, 72, True, False)]  # ragged: odd dims, Co tails, W = 1
    # the tiling's edges: W = 16 and 66, Co 16 and 72, Cin 40, circular at W < 64
    cases += [(2, 16, 16, 256, 128, False, True), (1, 5, 66, 64, 64, False, True),
              (2, 4, 64, 64, 16, True, False), (2, 6, 20, 40, 16, False, True),
              (2, 11, 24, 64, 72, True, True), (1, 2, 24, 128, 256, True, True)]
    gen = torch.Generator(device=device).manual_seed(12)
    max_err = max_ulps = max_beyond = 0.0
    equal = []
    for b, h, w, cin, co, circ, relu in cases:
        x, wt, bias = conv_inputs(gen, device, b, h, w, cin, co)
        e, u, eq, beyond = check_conv(
            f"B={b} HWC=({h}, {w}, {cin}) Co={co} circular={circ} relu={relu}",
            x, wt, bias, circ, relu)
        max_err, max_ulps, max_beyond = max(max_err, e), max(max_ulps, u), max(max_beyond, beyond)
        equal.append(eq)
        del x
    log(f"    {len(cases)} cases: max_abs_err {max_err:.3e}, max {max_ulps:.3f} bf16 ulp "
        f"(share beyond one ulp at most {max_beyond:.2e}, each within the f32 order bound), "
        f"bit-equal share {min(equal):.6f} (worst case) .. {statistics.mean(equal):.6f} (mean)")
    x, wt, bias = conv_inputs(gen, device, 2, 32, 64, 64, 64)
    grads = []
    for fn in (conv3x3.conv3x3_bias_relu, conv3x3.conv3x3_bias_relu_plain):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, wt, bias))
        y = fn(xs, ws, bs, False, True)
        y.float().square().sum().backward()
        grads.append((xs.grad.float(), ws.grad.float(), bs.grad.float()))
    for name, got, want in zip(("input", "weight", "bias"), *grads):
        rel = float((got - want).abs().max() / want.abs().max())
        log(f"    gradient {name} at [2, 32, 64, 64] -> 64: max |d| / max |g| = {rel:.3e} "
            f"(rtol {GRAD_RTOL})")
        if not torch.allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_RTOL * float(want.abs().max())):
            raise AssertionError(f"conv3x3_bf16 {name} gradient disagrees with the plain version")

    # 13. FOV training at full width through the kernel
    batch_size, n_train, n_val = cfg.train.batch_size, 8, 2
    log(f"[13] loop.train: fov_experiment('cvusa', 360), batch {batch_size}, 1 epoch of "
        f"{n_train} train + {n_val} val steps, synthetic batches, checkpoints")
    train_loader = list(synthetic_loader(cfg, n_train * batch_size, batch_size, 13))
    val_loader = list(synthetic_loader(cfg, n_val * batch_size, batch_size, 14))
    pipeline = FovPipeline(cfg, device)
    init = pipeline.init_state(torch.Generator().manual_seed(cfg.train.seed))
    start = {t: {k: v.detach().clone() for k, v in p.items()} for t, p in init.params.items()}
    trainable = {t: set(pipeline.trainable_names(p)) for t, p in start.items()}
    del init
    seen = {"train": [], "val": []}

    def counted(fn, phase):
        def run(*args):
            before = conv3x3.launches
            out = fn(*args)
            metrics = out[1] if phase == "train" else out
            seen[phase].append((conv3x3.launches - before, float(metrics["loss"])))
            return out
        return run

    pipeline.train_step = counted(pipeline.train_step, "train")
    pipeline.eval_step = counted(pipeline.eval_step, "val")
    ckpt_dir = Path(__file__).resolve().parent / ".smoke_checkpoints"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    checkpointer = Checkpointer(str(ckpt_dir), keep=cfg.train.keep_checkpoints)
    conv3x3.launches = 0
    t0 = time.perf_counter()
    state = loop.train(cfg, pipeline, train_loader, val_loader, num_epochs=1,
                       checkpointer=checkpointer, verbose=False)
    torch.cuda.synchronize()
    conv_launches = conv3x3.launches
    log(f"    trained {state.step} steps in {time.perf_counter() - t0:.2f} s; conv3x3_bf16 "
        f"launches: train {sum(n for n, _ in seen['train'])}, val "
        f"{sum(n for n, _ in seen['val'])}, path {conv_launches}")
    log(f"    losses: train {[round(v, 6) for _, v in seen['train']]}, val "
        f"{[round(v, 6) for _, v in seen['val']]}")
    if len(seen["train"]) != n_train or len(seen["val"]) != n_val or state.step != n_train:
        raise AssertionError(f"expected {n_train} train and {n_val} val steps, got "
                             f"{len(seen['train'])} and {len(seen['val'])}")
    if not all(n > 0 for n, _ in seen["train"] + seen["val"]):
        raise AssertionError("a train or val step did not launch the conv kernel")
    if not all(np.isfinite(v) for _, v in seen["train"] + seen["val"]):
        raise AssertionError("non-finite loss")
    moved = frozen_changed = 0
    for tower, p in state.params.items():
        for name, v in p.items():
            same = torch.equal(v.detach(), start[tower][name])
            if name in trainable[tower]:
                moved += not same
                if same:
                    raise AssertionError(f"trainable {tower}/{name} did not move")
            elif not same:
                frozen_changed += 1
    if frozen_changed:
        raise AssertionError(f"{frozen_changed} frozen params changed")
    log(f"    {moved} trainable params moved, every frozen one bit-unchanged")
    fresh = pipeline.init_state(torch.Generator().manual_seed(cfg.train.seed + 1))
    checkpointer.restore("latest", fresh)
    restored_ok = fresh.step == state.step and all(
        torch.equal(v, state.params[t][k]) for t, p in fresh.params.items() for k, v in p.items())
    opt_a, opt_b = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    restored_ok = restored_ok and opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i])
    if not restored_ok:
        raise AssertionError("restoring `latest` did not give the saved tensors")
    log(f"    `latest` restores step {fresh.step}, params and Adam moments equal to the saved ones; "
        f"best val loss {checkpointer.best_val_loss():.6f}")
    del fresh
    shutil.rmtree(ckpt_dir)

    repeat = FovPipeline(cfg, device)
    rstate = repeat.init_state(torch.Generator().manual_seed(cfg.train.seed))
    one = train_loader[0]
    curve = [float(repeat.train_step(rstate, one, torch.Generator().manual_seed(5))[1]["loss"])
             for _ in range(8)]
    log(f"    one repeated batch, same draws each step: losses {[round(v, 6) for v in curve]}")
    if not curve[-1] < curve[0] or not all(np.isfinite(curve)):
        raise AssertionError("the loss did not fall over 8 steps on one repeated batch")
    del rstate

    cpu_params = {t: {k: v.detach().cpu() for k, v in p.items()} for t, p in state.params.items()}
    small = raw_batch(np.random.default_rng(6), cfg, 2)
    s_in, p_in = pipeline.preprocess(small)
    for tower, circ, x in (("surface", False, s_in), ("overhead", True, p_in)):
        model = FovDsm(cfg.model, circ_padding=circ).eval()
        with torch.no_grad():
            gpu = functional_call(model.to(device), state.params[tower], (x,), strict=True).cpu()
            cpu = functional_call(model.cpu(), cpu_params[tower], (x.cpu(),), strict=True)
        scale = float(cpu.abs().max())
        err = float((gpu - cpu).abs().max())
        log(f"    trained bf16 {tower} tower, 2 samples at full geometry: GPU (kernel) vs CPU "
            f"(plain) max |d emb| = {err:.3e}, {err / scale:.3e} of max |emb| "
            f"(rtol 2e-2, atol 2e-2 * max |emb|)")
        if not torch.allclose(gpu, cpu, rtol=2e-2, atol=2e-2 * scale):
            raise AssertionError(f"trained bf16 {tower} tower: GPU disagrees with CPU")

    # 14. timing (CUDA events, warm, median)
    log(f"[14] conv3x3_bf16 and training timing on {card}")
    staged = [{k: torch.as_tensor(v, device=device) for k, v in b.items()} for b in train_loader[:4]]
    step_of = iter(range(10**9))
    gen = torch.Generator().manual_seed(14)

    def train_once():
        pipeline.train_step(state, staged[next(step_of) % len(staged)], gen)

    t_train = cuda_ms(train_once, 4, 5)
    log(f"    train step batch {batch_size} (fov 360, varied inputs): {t_train:.3f} ms/step, "
        f"{batch_size * 1000.0 / t_train:.2f} pairs/s ({card})")
    del staged, state

    per_shape = []
    gen = torch.Generator(device=device).manual_seed(15)
    for h, w, cin, co, circ, relu in (bf16_conv_shapes(d.surface_height, d.surface_width_max, 3, False)
                                      + bf16_conv_shapes(d.surface_height, d.surface_width_max,
                                                         3, True)):
        x, wt, bias = conv_inputs(gen, device, 128, h, w, cin, co)
        packed = conv3x3.pack_weights(wt)
        t_k, t_p = interleaved_ms(
            lambda: conv3x3.conv3x3_bias_relu_plain(x, wt, bias, circ, relu),
            lambda: conv3x3.conv3x3_bias_relu_kernel(x, packed, bias, circ, relu), calls=3, reps=5)
        t_lib = cuda_ms(library_conv(x, wt, bias, relu), 3, 5)
        flop, nbytes = conv_work(128, h, w, cin, co)
        t_b, by = bound(flop, nbytes, PEAK_BF16_PER_MS)
        per_shape.append((circ, t_k, t_p, t_lib, t_b, by))
        log(f"    B=128 HWC=({h}, {w}, {cin}) Co={co} circular={circ} relu={relu}: kernel "
            f"{t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s), plain {t_p:.4f} ms, library "
            f"{t_lib:.4f} ms ({flop / t_lib / 1e9:.1f} TFLOP/s), bound {t_b:.4f} ms ({by}) "
            f"({card})")
        del x, packed
    surf = [r for r in per_shape if not r[0]]
    t_k, t_p, t_lib, t_b = (sum(r[i] for r in surf) for i in range(1, 5))
    by = max(("operations", "bytes"), key=lambda k: sum(r[4] for r in surf if r[5] == k))
    log(f"    the surface tower's {len(surf)} fused convs summed, batch 128: kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, library {t_lib:.4f} ms, bound {t_b:.4f} ms ({card})")
    return {
        "name": "conv3x3_bias_relu", "route": "cuda", "source": CONV_SOURCE,
        "replaces": CONV_REPLACES, "launches": conv_launches, "max_abs_err": max_err,
        "max_ulp_err": max_ulps, "ms": t_k, "plain_ms": t_p, "bound_ms": t_b,
        "bound_by": by, "library_ms": t_lib,
    }, batch_size * 1000.0 / t_train

# --- the int8 profiling harness (phases 15-17) --------------------------------

PROBE_KERNELS = {  # record name: (source, TPU kernels it replaces)
    "conv_like": ("witw_tpu_torch/csrc/conv_like.cu", "exp/int8_isolate.py:56"),
    "mm_s8": ("witw_tpu_torch/csrc/mm_probe.cu",
              "exp/int8_mm_probe.py:33, exp/mosaic_caps.py:82"),
    "mm_bf16": ("witw_tpu_torch/csrc/mm_probe.cu", "exp/int8_mm_probe.py:60"),
    "caps": ("witw_tpu_torch/csrc/caps.cu",
             "exp/mosaic_caps.py:45, exp/mosaic_caps.py:63, exp/mosaic_caps.py:108"),
}
# the rate probes' larger rep counts at N = 128
MM_REPS = {"mm_s8": int8_mm_probe.REPS_S8[1], "mm_bf16": int8_mm_probe.REPS_BF16[1]}


def sass_counts(library: Path, opcodes):
    """{kernel symbol: {opcode: SASS instructions}} of a built library."""
    sass = subprocess.run([str(Path(nvcc_path()).parent / "cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op in opcodes:
                counts[fn][op] += f" {op}" in line
    return counts


def conv_like_case(gen, device, b, h, w, c, n):
    """The TPU script's inputs at one shape: xp [B, H + 2, WP8, C] in
    [-127, 127], wmat [9C, N] in [-20, 20], m = 0.001."""
    wp8 = -(-(w + 2) // 32) * 32
    xp = torch.randint(-127, 128, (b, h + 2, wp8, c), generator=gen, device=device,
                       dtype=torch.int8)
    wmat = torch.randint(-20, 21, (9 * c, n), generator=gen, device=device, dtype=torch.int8)
    return xp, wmat, torch.full((1, n), 0.001, device=device)


def probe_phases(card, device, built):
    """Phases 15-17; returns the four records of the probes' kernels."""
    # 15. the three libraries, built in phase 2; dp4a in each conv_like mode
    int8_isolate._lib()
    int8_mm_probe._lib()
    mosaic_caps._lib()
    log(f"[15] {', '.join(built[n][0].name for n in PROBE_LIBRARIES)} (built in phase 2)")
    for name in PROBE_LIBRARIES:
        print_ptxas(built[name][1])
    counts = sass_counts(built["conv_like"][0], ("IDP.4A", "LDG", "LDS"))
    per_mode = {mode: next(c for f, c in counts.items() if f"conv_like_kernelILi{i}E" in f)
                for i, mode in enumerate(int8_isolate.MODES)}
    log(f"    SASS instructions per conv_like mode: {per_mode}")
    fewer = [m for m, c in per_mode.items() if c["IDP.4A"] < per_mode["full"]["IDP.4A"]]
    if fewer:
        raise AssertionError(f"conv_like modes {fewer} issue fewer IDP.4A than full: the "
                             f"compiler removed work")

    # 16. each kernel against its plain version
    log("[16] probe kernels vs plain PyTorch: conv_like and mm bit-equal, the stripped modes "
        "zero, mmf bit-equal at reps 1 and within 1024 * 2^-24 * max|y| at reps 1024, t1-t4 "
        "bit-equal")
    gen = torch.Generator(device=device).manual_seed(16)
    err = dict.fromkeys(PROBE_KERNELS, 0.0)
    iso = int8_isolate
    for shape in ((iso.B, iso.H, iso.W, iso.C, iso.N), (3, 16, 40, 32, 64)):
        xp, wmat, m = conv_like_case(gen, device, *shape)
        want = int8_isolate.conv_like_plain(xp, wmat, m, "full", shape[2])
        if len(want.unique()) <= 20:
            raise AssertionError("conv_like's test outputs do not spread over [0, 127]")
        for mode in int8_isolate.MODES:
            got = int8_isolate.conv_like(xp, wmat, m, mode, shape[2])
            plain = want if mode == "full" else int8_isolate.conv_like_plain(xp, wmat, m, mode,
                                                                             shape[2])
            e = check_equal(f"conv_like {mode} B,H,W,C,N={shape}", got, plain)
            if mode != "full" and bool(got.any()):
                raise AssertionError(f"conv_like {mode} is not all zero")
            err["conv_like"] = max(err["conv_like"], e)
        del xp, want
    mp = int8_mm_probe
    a = torch.randint(-127, 128, (mp.M, mp.K), generator=gen, device=device, dtype=torch.int8)
    for n in (mp.N, mp.N2):
        b = torch.randint(-127, 128, (mp.K, n), generator=gen, device=device, dtype=torch.int8)
        for reps in (1, MM_REPS["mm_s8"]):
            e = check_equal(f"mm [{mp.M}x{mp.K}x{n}] reps {reps}", mp.mm(a, b, reps),
                            mp.mm_plain(a, b, reps))
            err["mm_s8"] = max(err["mm_s8"], e)
    ab = a.to(torch.bfloat16)
    bb = torch.randint(-127, 128, (mp.K, mp.N), generator=gen, device=device).to(torch.bfloat16)
    for reps in (1, MM_REPS["mm_bf16"]):
        got, want = mp.mmf(ab, bb, reps), mp.mmf_plain(ab, bb, reps)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        tol = 0.0 if reps == 1 else reps * 2.0 ** -24 * float(want.abs().max())
        log(f"  mmf [{mp.M}x{mp.K}x{mp.N}] reps {reps}: max_abs_err={e:.3e} (tolerance "
            f"{tol:.3e}), {float((got == want).float().mean()):.6f} bit-equal")
        if got.dtype != torch.float32 or not e <= tol:
            raise AssertionError(f"mmf disagrees with its plain version at reps {reps}")
        err["mm_bf16"] = max(err["mm_bf16"], e)
    # without the whole-dot pass (int8_mm_probe.run times it): exact at reps 1
    e = check_equal(f"mmf [{mp.M}x{mp.K}x{mp.N}] reps 1, tensor-core accumulation",
                    mp.mm_kernel(ab, mp.pack_b(bb), 1, whole_dots=False), mp.mmf_plain(ab, bb, 1))
    err["mm_bf16"] = max(err["mm_bf16"], e)
    x = torch.randint(-127, 128, (256, 128), generator=gen, device=device, dtype=torch.int8)
    w = torch.randint(-20, 21, (128, 64), generator=gen, device=device, dtype=torch.int8)
    slab = torch.randint(-127, 128, (8, 64, 128), generator=gen, device=device, dtype=torch.int8)
    caps_cases = {"t1": (x,), "t2": (x,), "t4": (slab,)}
    for name, args in caps_cases.items():
        e = check_equal(f"{name} {tuple(args[0].shape)}", getattr(mosaic_caps, name)(*args),
                        getattr(mosaic_caps, f"{name}_plain")(*args))
        err["caps"] = max(err["caps"], e)
    e = check_equal("t3 [256x128x64]", mosaic_caps.t3(x, w), mp.mm_plain(x, w, 1))
    err["mm_s8"] = max(err["mm_s8"], e)

    # 17. the three entry points, counted
    log("[17] the probes' entry points: int8_isolate.run, int8_mm_probe.run, mosaic_caps.run")
    counters = (int8_isolate.launches, int8_mm_probe.launches, mosaic_caps.launches)
    for c in counters:
        for k in c:
            c[k] = 0
    results = {}
    for mod, counted in ((int8_isolate, [(int8_isolate.launches, k) for k in int8_isolate.MODES]),
                         (int8_mm_probe, [(int8_mm_probe.launches, "mm"),
                                          (int8_mm_probe.launches, "mmf")]),
                         (mosaic_caps, [(mosaic_caps.launches, k) for k in ("t1", "t2", "t4")]
                          + [(int8_mm_probe.launches, "mm")])):
        name = mod.__name__.rsplit(".", 1)[1]
        before = [c[k] for c, k in counted]
        results[name] = mod.run(device)
        torch.cuda.synchronize()
        idle = [k for (c, k), b in zip(counted, before) if c[k] <= b]
        if idle:
            raise AssertionError(f"{name}.run() did not launch {idle}")
        if not all(v is True or (isinstance(v, float) and v > 0) for v in results[name].values()):
            raise AssertionError(f"{name}.run() reported {results[name]}")
    launches = {"conv_like": sum(int8_isolate.launches.values()),
                "mm_s8": int8_mm_probe.launches["mm"], "mm_bf16": int8_mm_probe.launches["mmf"],
                "caps": sum(mosaic_caps.launches.values())}
    iso_ms = results["int8_isolate"]
    log(f"    launches {launches}; kernel A decomposed: input copies (full - nodma) "
        f"{iso_ms['full'] - iso_ms['nodma']:.4f} ms, shifted operand reads (full - nopatch) "
        f"{iso_ms['full'] - iso_ms['nopatch']:.4f} ms of {iso_ms['full']:.4f} ms ({card})")

    # Timing for the records, outside the counted path (CUDA events, median of 5)
    log(f"    probe kernels beside their plain versions and the library on {card}")
    xp, wmat, m = conv_like_case(gen, device, iso.B, iso.H, iso.W, iso.C, iso.N)
    w_packed = int8_isolate.pack_wmat(wmat)
    times = {"conv_like": interleaved_ms(
        lambda: int8_isolate.conv_like_plain(xp, wmat, m, "full", iso.W),
        lambda: int8_isolate.conv_like_kernel(xp, w_packed, m, "full", iso.W), calls=2, reps=5)
        + (None,)}
    ops = 2.0 * 9 * iso.C * iso.N * iso.B * iso.H * iso.W
    bounds = {"conv_like": bound(ops, xp.numel() + wmat.numel() + 4 * iso.N
                                 + iso.B * iso.H * iso.W * iso.N, PEAK_INT8_PER_MS)}
    del xp
    b = torch.randint(-127, 128, (mp.K, mp.N), generator=gen, device=device, dtype=torch.int8)
    for rec, x_, y_, plain, peak, size in (
            ("mm_s8", a, b, mp.mm_plain, PEAK_INT8_PER_MS, 1),
            ("mm_bf16", ab, bb, mp.mmf_plain, PEAK_BF16_PER_MS, 2)):
        reps, bt = MM_REPS[rec], mp.pack_b(y_)
        t_k, t_p = interleaved_ms(lambda: plain(x_, y_, reps), lambda: mp.mm_kernel(x_, bt, reps),
                                  calls=1, reps=5)
        t_lib = reps * mp.library_ms(x_, bt)  # one cuBLAS product's device time x reps
        times[rec] = (t_k, t_p, t_lib)
        bounds[rec] = bound(2.0 * mp.M * mp.K * mp.N * reps,
                            size * (mp.M * mp.K + mp.K * mp.N) + 4 * mp.M * mp.N, peak)
    caps_lib = {"t1": lambda x_: x_.view(x_.shape[0], 2, -1).sum(1, dtype=torch.int32),
                "t2": lambda x_: torch.roll(x_, x_.shape[1] // 2, 1),
                "t4": lambda x_: x_.reshape(-1, x_.shape[-1]).clone()}
    caps_t = []  # launch-bound: device time from CUDA graphs of 64 calls
    for name, (arg,) in caps_cases.items():
        caps_t.append(tuple(graph_ms(lambda f=f: f(arg)) for f in (
            getattr(mosaic_caps, name), getattr(mosaic_caps, f"{name}_plain"), caps_lib[name])))
        log(f"    {name} {tuple(arg.shape)}: kernel {caps_t[-1][0]:.4f} ms, plain "
            f"{caps_t[-1][1]:.4f} ms, library {caps_t[-1][2]:.4f} ms (device time) ({card})")
    times["caps"] = tuple(sum(t[i] for t in caps_t) for i in range(3))
    caps_bytes = x.numel() * (1 + 2) + x.numel() * 2 + slab.numel() * 2  # t1 writes int32 halves
    bounds["caps"] = bound(0.0, caps_bytes, PEAK_INT8_PER_MS)
    records = []
    for rec, (source, replaces) in PROBE_KERNELS.items():
        t_k, t_p, t_lib = times[rec]
        log(f"    {rec}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
            f"{'none' if t_lib is None else f'{t_lib:.4f} ms'}, bound {bounds[rec][0]:.4f} ms "
            f"({bounds[rec][1]}; H100 SXM peaks) ({card})")
        records.append({
            "name": rec, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[rec], "max_abs_err": err[rec], "ms": t_k, "plain_ms": t_p,
            "bound_ms": bounds[rec][0], "bound_by": bounds[rec][1], "library_ms": t_lib,
        })
    return records


# --- FOV serving: build_index, GalleryIndex and the daemon (18-20) -----------

SERVE_DIR = Path(__file__).resolve().parent / ".smoke_serving"
SERVE_TILES = 512
INDEX_TILES = 100_000


@contextlib.contextmanager
def plain_kernels():
    """The towers' kernel wrappers swapped for their plain PyTorch versions
    where the towers call them, so that the same calls run without the
    kernels on the card."""
    swaps = [
        (vgg16, "conv3x3_bias_relu", conv3x3.conv3x3_bias_relu_plain),
        (quantize, "conv3x3_int8",
         lambda x, w, b, m, sh=1, pw=1, relu=True, w_wgmma=None:
         int8_conv.conv3x3_int8_plain(x, w, b, m, sh, pw, relu)),
        (quantize, "conv3x3_int8_dequant",
         lambda x, w, dq, bf, sh=1, pw=1, w_wgmma=None:
         int8_conv.conv3x3_int8_dequant_plain(x, w, dq, bf, sh, pw)),
        (quantize, "maxpool2x2", maxpool.maxpool2x2_plain),
        (quantize, "fused_block2",
         lambda *args, circular=False, w1_wgmma=None, w2_wgmma=None:
         fused_block2.fused_block2_plain(*args, circular=circular)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_serving_dataset(directory: Path, n: int, shards: int = 8) -> str:
    """A WITW-schema dataset of n synthetic tiles, written by
    write_synthetic_dataset in ``shards`` parts at once (seeds 0, 1, ...),
    whose CSV lists them all with tile-centre coordinates in columns 0 and 1
    (x = 1000 + 10 i, y = -5 i), for --meta-cols."""
    def part(k):
        return synthetic.write_synthetic_dataset(
            str(directory / f"part{k}"), n=n // shards, schema="witw", surface_hw=(16, 64),
            overhead_hw=(256, 256), seed=k)

    with concurrent.futures.ThreadPoolExecutor(shards) as pool:
        parts = list(pool.map(part, range(shards)))
    header, rows = None, []
    for k, csv_part in enumerate(parts):
        with open(csv_part) as f:
            header, *lines = f.read().splitlines()
        rows += [line.replace("surface/", f"part{k}/surface/").replace("overhead/", f"part{k}/overhead/")
                 for line in lines]
    rows = [f"{1000 + 10 * i},{-5 * i}" + line[1:] for i, line in enumerate(rows)]
    csv_path = directory / "pairs.csv"
    csv_path.write_text("\n".join([header] + rows) + "\n")
    return str(csv_path)


def check_index_build(index, cfg, params, sq, int8, tiles=None):
    """The first 8 embeddings of a built index against the same tiles
    (``tiles``, or those of the index's paths) run through the plain
    versions of the kernels on the card: bf16 cosine >= 0.999 per
    embedding, int8 within phase 9's atol 1e-6. FOV maps or, for a SAFA
    config, vectors (``sq`` then the (tables, head) pair)."""
    d = cfg.data
    safa = cfg.model.kind == "vgg_safa"
    if tiles is None:
        tiles = np.stack([loader.resize_host(loader.decode_image(p)[..., :3], d.overhead_size,
                                             d.overhead_size) for p in index.meta["path"][:8]])
    x = torch.from_numpy(tiles).to(index.device)
    polar = polar_transform(normalize_images(x, d.img_mean, d.img_std), d.surface_height,
                            d.surface_width_max)
    if safa:
        model = VggSafa(cfg.model, (d.surface_height, d.surface_width_max), True)
    else:
        model = FovDsm(cfg.model, circ_padding=True)
    model = model.to(index.device).eval()
    got = torch.from_numpy(index.embeds[:8]).to(index.device)
    with torch.no_grad(), plain_kernels():
        if int8 and safa:
            want = quantize.quantized_safa_forward_static(*sq, polar, True)
        elif int8:
            want = quantize.quantized_fov_forward_static(sq, polar, True)
        else:
            want = functional_call(model, params["overhead"], (polar,), strict=True)
    if int8:
        err = float((got - want).abs().max())
        log(f"    int8 index, first 8 embeddings vs plain kernels on the card: max |d emb| "
            f"{err:.3e} (atol {INT8_ATOL})")
        if not err <= INT8_ATOL:
            raise AssertionError("int8 index embeddings disagree with the plain kernels")
        return
    cos = torch.nn.functional.cosine_similarity(got.reshape(8, -1), want.reshape(8, -1), dim=1)
    log(f"    bf16 index, first 8 embeddings vs plain kernels on the card: cosine min "
        f"{float(cos.min()):.6f} (>= 0.999)")
    if not bool((cos >= 0.999).all()):
        raise AssertionError("bf16 index embeddings disagree with the plain kernels")


def check_daemon_embeds(service, seen, int8):
    """Every group of photos the daemon embedded against the same photos
    through its surface tower with the kernels' plain versions on the card
    (int8: with the daemon's calibrated tables): bf16 cosine >= 0.999 per
    embedding, int8 within phase 9's atol 1e-6. Returns (the groups' batch
    sizes, the least cosine or the largest |d emb|)."""
    worst = 0.0 if int8 else 1.0
    with torch.no_grad(), plain_kernels():
        for imgs, got in seen:
            x = service._tower_input(torch.from_numpy(imgs).to(service.device))
            if int8 and service.family == "safa":
                want = quantize.quantized_safa_forward_static(*service._sq, x, False)
            elif int8:
                want = quantize.quantized_fov_forward_static(service._sq, x, False)
            else:
                want = service._tower(x)
            got = torch.from_numpy(got).to(service.device)
            want = want.float().reshape(got.shape)
            if int8:
                worst = max(worst, float((got - want).abs().max()))
            else:
                cos = torch.nn.functional.cosine_similarity(got.reshape(len(got), -1),
                                                            want.reshape(len(got), -1), dim=1)
                worst = min(worst, float(cos.min()))
    if not (worst <= INT8_ATOL if int8 else worst >= 0.999):
        raise AssertionError(f"the {'int8' if int8 else 'bf16'} daemon's embeddings disagree with "
                             f"the plain kernels: {'max |d emb|' if int8 else 'cosine min'} {worst}")
    return sorted({len(imgs) for imgs, _ in seen}), worst


def phase_build_index(card, device, cfg):
    """[18] tools/build_index.main on a 512-tile WITW dataset, bf16 then
    --int8; returns (the two indexes, the params, launches per kernel)."""
    log(f"[18] tools.build_index.main: {SERVE_TILES} synthetic WITW tiles (256 x 256), "
        f"fov_experiment('witw', 70), random weights from a seed, bf16 and --int8")
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    csv_path = write_serving_dataset(SERVE_DIR / "data", SERVE_TILES)
    log(f"    wrote the dataset in {time.perf_counter() - t0:.2f} s")
    state = FovPipeline(cfg, device).init_state(torch.Generator().manual_seed(0))
    Checkpointer(str(SERVE_DIR / "weights" / "fov_70_witw")).save("best", state)
    params = state.params
    counted = dict(INT8_MODULES, conv3x3=conv3x3)
    indexes, launches, seen = {}, {}, {}
    real_span = quantize.calibrate_overhead_span

    def record_span(*args, **kwargs):  # the int8 tables the build uses
        seen["sq"], items = real_span(*args, **kwargs)
        return seen["sq"], items

    quantize.calibrate_overhead_span = record_span
    try:
        for precision, flags, mods in (("bf16", [], ["conv3x3"]),
                                       ("int8", ["--int8"], list(INT8_MODULES))):
            out = SERVE_DIR / f"index_{precision}.npz"
            argv = ["--csv", csv_path, "--out", str(out), "--weights", str(SERVE_DIR / "weights"),
                    "--dataset", "witw", "--fov", "70", "--meta-cols", "col0:x,col1:y"] + flags
            for mod in counted.values():
                mod.launches = 0
            t0 = time.perf_counter()
            build_index.main(argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[precision] = {n: counted[n].launches for n in mods}
            idle = [n for n, c in launches[precision].items() if c < 1]
            if idle:
                raise AssertionError(f"build_index {precision} did not launch {idle}")
            index = GalleryIndex.load(str(out))
            meta = index.meta
            d = cfg.data
            if (index.embeds.shape != (SERVE_TILES, d.surface_height // 32, d.surface_width_max // 8, 16)
                    or not np.isfinite(index.embeds).all()
                    or str(meta["precision"]) != ("int8" if flags else "f32")
                    or str(meta["params_sha"]) != params_fingerprint(params["overhead"])
                    or not np.array_equal(meta["x"], 1000.0 + 10 * np.arange(SERVE_TILES))):
                raise AssertionError(f"{precision} index: embeds {index.embeds.shape}, meta "
                                     f"{ {k: str(v)[:40] for k, v in meta.items()} }")
            log(f"    {precision}: {SERVE_TILES} tiles in {dt:.3f} s = {SERVE_TILES / dt:.2f} "
                f"tiles/s (decode, resize, upload, embed; host clock) ({card}); launches "
                f"{launches[precision]}; precision {str(meta['precision'])!r}, params_sha "
                f"{str(meta['params_sha'])[:12]}...")
            check_index_build(index, cfg, params, seen.get("sq"), bool(flags))
            indexes[precision] = index
    finally:
        quantize.calibrate_overhead_span = real_span
    return indexes, params, launches


def phase_gallery_index(card, device):
    """[19] GalleryIndex at 100,000 tiles [N, 4, 64, 16], resident."""
    log(f"[19] GalleryIndex, {INDEX_TILES} planted tiles [N, 4, 64, 16] f32, resident: "
        f"search, score_all resident and streamed, search_approx, fast")
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(7)
    embeds = torch.randn(INDEX_TILES, 4, 64, 16, generator=gen, device=device).cpu().numpy()
    planted = rng.choice(INDEX_TILES, 8, replace=False)
    starts = rng.integers(0, 64, 8)
    queries = {}
    for sw in (64, 12):
        cols = (starts[:, None] + np.arange(sw)[None]) % 64
        q = np.stack([embeds[g][:, c] for g, c in zip(planted, cols)])
        queries[sw] = (q + 0.1 * rng.standard_normal(q.shape, dtype=np.float32)).astype(np.float32)
    log(f"    made the gallery in {time.perf_counter() - t0:.2f} s "
        f"({embeds.nbytes / 1e9:.2f} GB f32)")
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    index = GalleryIndex(embeds, device=device)
    timings = {}
    for sw, q in queries.items():
        i_s, d_s, o_s = index.search(q, k=10)
        d_res, o_res = index.score_all(q, resident=True)
        d_str, o_str = index.score_all(q, resident=False)
        order = np.argsort(d_str, axis=0, kind="stable")[:10].T  # [Q, 10]
        rows = np.arange(len(q))[:, None]
        if not np.array_equal(i_s, order):
            raise AssertionError(f"sw {sw}: search's top-10 differs from streamed score_all's")
        if not (np.array_equal(o_s, o_str[order, rows]) and np.array_equal(o_s, o_res[order, rows])):
            raise AssertionError(f"sw {sw}: top-10 orientations differ between the three paths")
        err = max(float(np.abs(d_s - d_str[order, rows]).max()), float(np.abs(d_res - d_str).max()))
        flips = int((o_res != o_str).sum())
        if not err <= 1e-5 or not np.array_equal(i_s[:, 0], planted):
            raise AssertionError(f"sw {sw}: distances {err:.3e} apart, top-1 {i_s[:, 0]} "
                                 f"(planted {planted})")
        i_a, _, o_a = index.search_approx(q, k=10, candidates=256)
        i_f, _, o_f = index.search(q, k=10, fast=True)
        if not (np.array_equal(i_a[:, 0], i_s[:, 0]) and np.array_equal(i_f[:, 0], planted)
                and np.array_equal(o_f[:, 0], o_s[:, 0])):
            raise AssertionError(f"sw {sw}: approx top-1 {i_a[:, 0]}, fast top-1 {i_f[:, 0]}, "
                                 f"exact {i_s[:, 0]}")
        log(f"    sw {sw}, Q 8: search(k=10) == streamed score_all's numpy top-10 (indices, "
            f"orientations; max |dd| {err:.3e} <= 1e-5 with resident score_all too; "
            f"{flips} of {o_res.size} orientations differ between resident and streamed "
            f"score_all, all off the top-10); search_approx(candidates=256) and fast "
            f"top-1 == planted")
        for qn in (1, 8):
            qq = q[:qn]
            calls = {"search": lambda: index.search(qq, k=10),
                     "search_approx": lambda: index.search_approx(qq, k=10, candidates=256),
                     "search fast": lambda: index.search(qq, k=10, fast=True),
                     "score_all": lambda: index.score_all(qq, resident=True)}
            if qn == 8:
                calls["score_all streamed"] = lambda: index.score_all(qq, resident=False)
            for name, fn in calls.items():
                reps = 2 if name == "score_all streamed" else 5
                timings[f"{name} sw {sw} Q {qn}"] = cuda_ms(fn, 1, reps)
    peak = torch.cuda.max_memory_allocated(device) - base
    for name, ms in timings.items():
        log(f"    {name}: {ms:.3f} ms per call (CUDA events, median of 5; streamed: of 2)")
    log(f"    peak device memory {peak / 1e9:.3f} GB above the baseline (max_memory_allocated; "
        f"resident tables {index._resident_bytes() / 1e9:.3f} GB by _resident_bytes) ({card})")
    del index
    torch.cuda.empty_cache()


def http_json(url: str, body: bytes = None):
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    except urllib.error.HTTPError as err:
        raise AssertionError(f"{url}: HTTP {err.code}: {err.read().decode()}") from None
    return out, time.perf_counter() - t0


def phase_daemon(card, device, cfg, indexes, params):
    """[20] GeolocateService behind serve() on 127.0.0.1, bf16 and --int8."""
    log("[20] tools.serve: GeolocateService(max_batch 8) behind serve() on 127.0.0.1:0, "
        f"the {SERVE_TILES}-tile indexes of [18]; 32 POST /geolocate?k=5 (PNG photos) 8 at a "
        "time, one candidates=64, /healthz, /stats")
    rng = np.random.default_rng(8)
    photos = [png_bytes(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)) for _ in range(32)]
    counted = dict(INT8_MODULES, conv3x3=conv3x3)
    launches = {}
    for precision, int8, mods in (("bf16", False, ["conv3x3"]), ("int8", True, list(INT8_MODULES))):
        index = indexes[precision]
        service = serve_tool.GeolocateService(index, cfg, params, int8=int8, max_batch=8)
        seen = []
        real_embed = service._embed

        def recording_embed(imgs, real_embed=real_embed, seen=seen):
            out = real_embed(imgs)
            seen.append((imgs, out))
            return out

        service._embed = recording_embed
        server = serve_tool.serve(service, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            service.warmup()
            seen.clear()
            for mod in counted.values():
                mod.launches = 0
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                answers = list(pool.map(lambda p: http_json(f"{url}/geolocate?k=5", p), photos))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches[precision] = {n: counted[n].launches for n in mods}
            idle = [n for n, c in launches[precision].items() if c < 1]
            if idle:
                raise AssertionError(f"the {precision} daemon did not launch {idle}")
            approx, _ = http_json(f"{url}/geolocate?k=5&candidates=64", photos[0])
            health, _ = http_json(f"{url}/healthz")
            stats, _ = http_json(f"{url}/stats")
            # Each answer against a direct index.search of the embeddings the
            # daemon computed for that photo's group (its rows past the group's
            # requests copy the first row, as the daemon pads them).
            direct = []
            for imgs, embs in seen[:-1]:  # the last one embedded the candidates=64 photo
                i_d, d_d, o_d = index.search(embs, k=service._k_bucket(5))
                direct += [(imgs[r], i_d[r, :5], d_d[r, :5], o_d[r, :5]) for r in range(len(imgs))]
            for photo, (out, _) in zip(photos, answers):
                img = service._decode(photo)
                _, i_d, d_d, o_d = next(t for t in direct if np.array_equal(t[0], img))
                res = out["results"]
                if ([r["tile"] for r in res] != i_d.tolist()
                        or [r["orientation_deg"] for r in res]
                        != [float(o * 360.0 / index.embeds.shape[2] - 180.0) for o in o_d]
                        or [r["distance"] for r in res] != [float(v) for v in d_d]
                        or [r["x"] for r in res] != [1000.0 + 10 * t for t in i_d]):
                    raise AssertionError(f"{precision} daemon answer differs from the direct search")
            batches, worst = check_daemon_embeds(service, seen, int8)
            alone = real_embed(service._decode(photos[0])[None])[0].ravel()
            batched = next(e[r] for imgs, e in seen for r in range(len(imgs))
                           if np.array_equal(imgs[r], service._decode(photos[0]))).ravel()
            norms = float(np.linalg.norm(alone) * np.linalg.norm(batched))
            cos = float(np.dot(alone, batched)) / norms if norms else float(np.array_equal(alone, batched))
            if not cos >= 0.999:
                raise AssertionError(f"{precision}: a photo embedded alone and in its group: cosine {cos}")
            ap = approx["results"]
            if len(ap) != 5 or stats["requests"] != 33 or stats["errors"] != 0 \
                    or health["gallery_size"] != SERVE_TILES or health["int8"] != int8:
                raise AssertionError(f"{precision} daemon: approx {ap}, stats {stats}, health {health}")
            p50, p99 = (1e3 * float(np.percentile([t for _, t in answers], q)) for q in (50, 99))
            log(f"    {precision}: 32 requests in {wall:.3f} s = {32 / wall:.2f} requests/s, latency "
                f"p50 {p50:.2f} ms, p99 {p99:.2f} ms "
                f"(host clock, 8 clients) ({card}); mean batch {stats['mean_batch']}, "
                f"{stats['dispatches']} dispatches; launches {launches[precision]}; every answer "
                f"== index.search on the daemon's embeddings; those embeddings (batches {batches}, "
                f"128 x 99 photos) vs the plain kernels on the card: "
                f"{'max |d emb|' if int8 else 'cosine min'} {worst:.6g} "
                f"({'atol 1e-6' if int8 else '>= 0.999'}); one photo embedded alone vs in its "
                f"group: cosine {cos:.6f}; candidates=64 top-1 tile "
                f"{ap[0]['tile']} (exact {answers[0][0]['results'][0]['tile']})")
        finally:
            server.shutdown()
            server.server_close()
            service.close()
    return launches


# --- the heatmap sweep and the training CLI (21-22) ---------------------------

HEATMAP_DIR = Path(__file__).resolve().parent / ".smoke_heatmap"
CLI_DIR = Path(__file__).resolve().parent / ".smoke_cli"
SWEEP_SIDE = 100  # tiles per side of the grid at the CLI's edge 225 m and offset 56.25 m
GSD = 0.3  # m per pixel, the WITW strips' ground resolution
SWEEP_ORIGIN = (447000.0, 5412000.0)  # (min easting, max northing) of the sweep bounds
CSV_HEADER = ["photo", "x", "y", "orientation", "dissimilarity", "score"]
CLI_PAIRS, CLI_VAL = 640, 128  # 8 train steps and 2 val steps at batch 64; 10 test batches


def sweep_bounds(tiles_per_side: int):
    """The UTM bounds of a sweep of ``tiles_per_side``^2 tiles at the CLI's
    offset 56.25 m from SWEEP_ORIGIN."""
    e0, n0 = SWEEP_ORIGIN
    span = tiles_per_side * 56.25 - 1.0
    return (e0, n0 - span, e0 + span, n0)


def write_strip(directory: Path, tiles_per_side: int = SWEEP_SIDE):
    """A synthetic 3-band uint8 strip at GSD around the bounds of a sweep of
    ``tiles_per_side``^2 tiles, written uncompressed as 03_paris.tif (the
    CLI's default AOI). Returns (the bounds, the strip's side in pixels)."""
    e0, n0 = SWEEP_ORIGIN
    span = tiles_per_side * 56.25 - 1.0
    bounds = sweep_bounds(tiles_per_side)
    margin = 150.0  # the windows reach 112.5 m past the bounds' low edges
    side = int(np.ceil((span + 2 * margin) / GSD))
    rng = np.random.default_rng(21)
    strip = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
    geotiff.write_geotiff_u8(str(directory / "03_paris.tif"), strip,
                             np.array([e0 - margin, GSD, 0.0, n0 + margin, 0.0, -GSD]), 32631,
                             compress=False)
    return bounds, side


def read_sweep_csv(path: Path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def phase_heatmap(card, device):
    """[21] tools.heatmap.main on a 10,000-tile grid, bf16 and --int8, cold
    and warm; returns launches per kernel (summed over the four runs). The
    strip, the --int8 index cache and the warm CSVs stay in HEATMAP_DIR for
    [30], which removes it."""
    cfg = fov_experiment("witw", 70)
    log(f"[21] tools.heatmap.main: a {SWEEP_SIDE} x {SWEEP_SIDE} grid ({SWEEP_SIDE ** 2} tiles of "
        f"225 m = 750^2 px resampled to 256^2), 2 photos, fov_experiment('witw', 70), random "
        f"weights from a seed; bf16 then --int8 on the same index cache, each cold then warm")
    shutil.rmtree(HEATMAP_DIR, ignore_errors=True)
    HEATMAP_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    bounds, side = write_strip(HEATMAP_DIR)
    rng = np.random.default_rng(22)
    photos = []
    for k in range(2):
        photos.append(str(HEATMAP_DIR / f"photo{k}.png"))
        (HEATMAP_DIR / f"photo{k}.png").write_bytes(
            png_bytes(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)))
    state = FovPipeline(cfg, device).init_state(torch.Generator().manual_seed(0))
    Checkpointer(str(HEATMAP_DIR / "weights" / "fov_70_witw")).save("best", state)
    params = state.params
    log(f"    wrote a {side} x {side} x 3 strip ({side * side * 3 / 1e9:.2f} GB, uncompressed), "
        f"the photos and the weights in {time.perf_counter() - t0:.2f} s")
    cache = HEATMAP_DIR / "tiles.npz"
    counted = dict(INT8_MODULES, conv3x3=conv3x3, fused_match=fused_match)
    launches, seen = {}, {}
    real_span, real_score = quantize.calibrate_overhead_span, GalleryIndex.score_all

    def record_span(*args, **kwargs):  # the int8 tables of the tile tower
        seen["sq"], items = real_span(*args, **kwargs)
        return seen["sq"], items

    def record_score(index, surface_embeds, *args, **kwargs):  # the photos' embeddings
        seen["s_emb"] = np.array(surface_embeds)
        return real_score(index, surface_embeds, *args, **kwargs)

    _, _, windows = heatmap.window_grid(bounds, 225.0, 56.25)
    with geotiff.GeoTiff(str(HEATMAP_DIR / "03_paris.tif")) as sat:
        size = cfg.data.overhead_size
        first_tiles = np.stack([geotiff.resample(sat.read_world_window(*w).astype(np.float32),
                                                 size, size) for w in windows[:8]])
    quantize.calibrate_overhead_span = record_span
    GalleryIndex.score_all = record_score
    try:
        for precision, flags, mods in (("bf16", [], ["conv3x3"]),
                                       ("int8", ["--int8"], list(INT8_MODULES))):
            argv = (["-a", "3", "-b", *map(str, bounds), "-s", str(HEATMAP_DIR), "-p", *photos,
                     "--weights", str(HEATMAP_DIR / "weights"), "--index-cache", str(cache)]
                    + flags)
            runs = {}
            launches[precision] = {n: 0 for n in counted}
            for run in ("cold", "warm"):
                out_csv = HEATMAP_DIR / f"{precision}_{run}.csv"
                for mod in counted.values():
                    mod.launches = 0
                torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                heatmap.main(argv + ["-c", str(out_csv)])
                torch.cuda.synchronize()
                runs[run] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated(device))
                for n, mod in counted.items():
                    launches[precision][n] += mod.launches
                idle = [n for n in mods if counted[n].launches < 1]
                if idle:
                    raise AssertionError(f"the {precision} {run} sweep did not launch {idle}")
                if run == "cold" and fused_match.launches:
                    raise AssertionError("the sweep launched the fused match; it scores through "
                                         "the FFT matcher")
            header, cold = read_sweep_csv(HEATMAP_DIR / f"{precision}_cold.csv")
            _, warm = read_sweep_csv(HEATMAP_DIR / f"{precision}_warm.csv")
            n = SWEEP_SIDE ** 2
            if header != CSV_HEADER or len(cold) != 2 * n or warm != cold:
                raise AssertionError(f"{precision} CSV: header {header}, {len(cold)} rows, warm "
                                     f"== cold {warm == cold}")
            d_col = np.asarray([r[4] for r in cold], np.float32)
            score = np.asarray([r[5] for r in cold], np.float32)
            if not (np.isfinite(d_col).all() and np.allclose(score, np.exp(10.0 * (1.0 - d_col)),
                                                             rtol=1e-6, atol=0)):
                raise AssertionError(f"{precision}: scores are not exp(10 (1 - d))")
            index = GalleryIndex.load(str(cache), device)
            meta = index.meta
            if (len(index) != n or str(meta["precision"]) != ("int8" if flags else "f32")
                    or str(meta["params_sha"]) != params_fingerprint(params["overhead"])):
                raise AssertionError(f"{precision} cache: {len(index)} tiles, meta "
                                     f"{ {k: str(v)[:40] for k, v in meta.items()} }")
            check_index_build(index, cfg, params, seen.get("sq"), bool(flags), first_tiles)
            q = seen["s_emb"]  # both photos, as the warm sweep embedded them
            d0, o0 = index.score_all(q[:1], gallery_chunk=2048)
            orient = o0[:, 0] * 360.0 / index.embeds.shape[2] - 180.0
            dd = float(np.abs(d0[:, 0] - d_col[:n]).max())
            if (not np.array_equal(orient, np.asarray([r[3] for r in cold[:n]], np.float64))
                    or not dd <= 1e-6):
                raise AssertionError(f"{precision}: photo 0's CSV rows differ from index.score_all "
                                     f"(max |dd| {dd})")
            t_score = cuda_ms(lambda: index.score_all(q, gallery_chunk=2048), 1, 5)
            sat_frac = f", int8_saturation {float(meta['int8_saturation']):.3e}" if flags else ""
            log(f"    {precision}: cold {runs['cold'][0]:.3f} s = {n / runs['cold'][0]:.2f} tiles/s "
                f"(arguments to CSV, host clock), peak device memory "
                f"{runs['cold'][1] / 1e9:.3f} GB; warm (cache hit) {runs['warm'][0]:.3f} s, peak "
                f"{runs['warm'][1] / 1e9:.3f} GB; score_all of {len(q)} photos at {n} tiles "
                f"{t_score:.3f} ms (CUDA events, median of 5) ({card}); launches "
                f"{ {k: v for k, v in launches[precision].items() if v} }; {len(cold)} rows == "
                f"warm rows, score == exp(10 (1 - d)), photo 0's rows == index.score_all (max "
                f"|dd| {dd:.3e}){sat_frac}")
            if flags and (len(index) != n or str(meta["precision"]) != "int8"):
                raise AssertionError("--int8 did not rebuild the bf16 cache")
    finally:
        quantize.calibrate_overhead_span = real_span
        GalleryIndex.score_all = real_score
    return launches


def write_cli_dataset(directory: Path, n: int, shards: int = 8) -> str:
    """A headerless CVUSA-schema CSV of n synthetic full-size pairs, written
    by write_synthetic_dataset in ``shards`` parts at once."""
    def part(k):
        return synthetic.write_synthetic_dataset(
            str(directory / f"part{k}"), n=n // shards, schema="cvusa", surface_hw=(128, 512),
            overhead_hw=(256, 256), seed=100 + k)

    with concurrent.futures.ThreadPoolExecutor(shards) as pool:
        parts = list(pool.map(part, range(shards)))
    lines = []
    for k, csv_part in enumerate(parts):
        lines += [",".join(f"part{k}/{p}" for p in line.split(","))
                  for line in Path(csv_part).read_text().splitlines()]
    path = directory / "pairs.csv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def phase_cli(card, device, staged_pairs_per_s):
    """[22] cli.cvig_fov.main at full CVUSA width: train one epoch, test,
    test --fast-eval; returns launches per kernel per run."""
    log(f"[22] cli.cvig_fov.main --dataset cvusa --fov 360 (batch 64): --mode train --epochs 1 on "
        f"{CLI_PAIRS} synthetic pairs ({CLI_PAIRS - CLI_VAL} train, val_quantity {CLI_VAL} by "
        f"wrapping run_train), then --mode test and --mode test --fast-eval")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    csv_path = write_cli_dataset(CLI_DIR / "data", CLI_PAIRS)
    log(f"    wrote the dataset in {time.perf_counter() - t0:.2f} s")
    flags = ["--dataset", "cvusa", "--fov", "360", "--train-csv", csv_path, "--test-csv", csv_path]
    real_run_train = cli_common.run_train

    def run_train_small_val(cfg, tag, num_epochs=None, profile_dir=None, device=None):
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, val_quantity=CLI_VAL))
        return real_run_train(cfg, tag, num_epochs=num_epochs, profile_dir=profile_dir,
                              device=device)

    counted = {"conv3x3": conv3x3, "fused_match": fused_match}
    launches = {}
    cwd = os.getcwd()
    os.chdir(CLI_DIR)  # the CLI's ./weights and ./runs
    cli_common.run_train = run_train_small_val
    try:
        results = {}
        for run, argv in (("train", ["--mode", "train", "--epochs", "1"]),
                          ("test", ["--mode", "test"]),
                          ("test --fast-eval", ["--mode", "test", "--fast-eval"])):
            for mod in counted.values():
                mod.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                results[run] = cvig_fov.main(argv + flags)
            torch.cuda.synchronize()
            launches[run] = {n: mod.launches for n, mod in counted.items()}
            log(f"    {run}: {time.perf_counter() - t0:.2f} s (host clock, arguments to return); "
                f"launches {launches[run]}")
        want = {"train": ("conv3x3",), "test": ("conv3x3", "fused_match"),
                "test --fast-eval": ("conv3x3",)}
        for run, mods in want.items():
            idle = [n for n in mods if launches[run][n] < 1]
            if idle:
                raise AssertionError(f"cvig_fov {run} did not launch {idle}")
        if launches["test --fast-eval"]["fused_match"] or launches["train"]["fused_match"]:
            raise AssertionError("--fast-eval or train launched the fused match")
        weights = CLI_DIR / "weights" / "fov_360_cvusa"
        if not ((weights / "best.pt").exists() and (weights / "latest.pt").exists()):
            raise AssertionError(f"no best.pt / latest.pt in {weights}")
        cfg = cli_common.apply_overrides(fov_experiment("cvusa", 360),
                                         cli_common.base_parser(True).parse_args(flags))
        steps = (CLI_PAIRS - CLI_VAL) // cfg.train.batch_size + -(-CLI_VAL // cfg.train.batch_size)
        records = [json.loads(line) for line in
                   (CLI_DIR / "runs" / "fov_360_cvusa" / "train" / "metrics.jsonl").read_text()
                   .splitlines()]
        keys = {tuple(r) for r in records}
        allowed = {("t", "tag", "value", "step"), ("t", "tag", "text", "step"),
                   ("t", "tag", "embedding_shape", "step")}
        tags = {r["tag"] for r in records}
        losses = [r["value"] for r in records if r["tag"] in ("train loss", "val loss")]
        if (not keys <= allowed or not {"train loss", "val loss", "train pairs_per_sec",
                                        "val_embedding", "best_loss"} <= tags
                or len(losses) != steps or not np.isfinite(losses).all()):
            raise AssertionError(f"train metrics.jsonl: keys {keys}, tags {tags}, losses {losses}")
        cli_rate = next(r["value"] for r in records if r["tag"] == "train pairs_per_sec")

        # test mode's metrics == loop.test on the restored best params
        pipeline = FovPipeline(cfg, device)
        params = Checkpointer(str(weights)).restore(
            "best", pipeline.init_state(torch.Generator().manual_seed(0))).params
        test_loader = cli_common.build_loader(
            cfg, read_pair_paths(cfg.data.dataset, csv_path), shuffle=False, drop_last=False,
            batch_size=cfg.eval.batch_size)
        try:
            direct = loop.test(cfg, pipeline, test_loader, params, verbose=False)
        finally:
            test_loader.close()
        if direct != results["test"]:
            raise AssertionError(f"test mode {results['test']} != loop.test {direct}")
        fast = results["test --fast-eval"]
        if fast["locations"] != CLI_PAIRS or not np.isfinite(list(fast.values())).all():
            raise AssertionError(f"--fast-eval metrics {fast}")
        o_pl, s_pl = planted_embeddings(np.random.default_rng(23), 1024, 4, 64, 16, 64)
        r_fast = FovGalleryEvaluator(fast_matmul=True, device=device).ranks(o_pl, s_pl)
        r_exact = FovGalleryEvaluator(use_fused=True, device=device).ranks(o_pl, s_pl)
        if not np.array_equal(r_fast == 1, r_exact == 1):
            raise AssertionError("--fast-eval's top-1 differs from the exact path's on planted "
                                 "embeddings")
        log(f"    losses finite {[round(v, 5) for v in losses]}; best.pt, latest.pt; metrics.jsonl "
            f"records {sorted(keys)}; test {json.dumps(results['test'])} == loop.test on the "
            f"restored best; --fast-eval {json.dumps(fast)}, planted [1024, 4, 64, 16] top-1 "
            f"{float(np.mean(r_fast == 1)):.4f} == the fused path's")
        log(f"    train through the CLI: {cli_rate:.2f} pairs/s (the loop's StepTimer, host clock, "
            f"steps 3-8 of 8) against {staged_pairs_per_s:.2f} on staged device batches ([14]) "
            f"({card})")
    finally:
        cli_common.run_train = real_run_train
        os.chdir(cwd)
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches


# --- the SAFA family: towers and ranks, serving, the CLI (23-25) --------------

SAFA_DIR = Path(__file__).resolve().parent / ".smoke_safa"
SAFA_SWEEP_SIDE = 50  # 2,500 tiles
SAFA_REQUESTS = 16
SAFA_CLI_PAIRS, SAFA_CLI_VAL = 320, 64  # 8 train and 2 val steps at batch 32; 10 test batches
RANK_PAIRS, RANK_D = 8832, 4096


def lattice(gen, shape, device):
    """Vectors of integers in [-2, 2]: every product and sum of two of them
    at D = 4096 is an integer under 2^24, exact in f32 and f64 alike, so
    distances (and their ties) compare exactly against a numpy oracle."""
    return torch.randint(-2, 3, shape, generator=gen, device=device, dtype=torch.int8).float()


def planted_queries(gen, gallery, rows, redrawn):
    """Gallery rows ``rows`` with each coordinate redrawn with probability
    ``redrawn[i]`` (a tensor): the more redrawn, the larger the true match's
    distance."""
    q = gallery[rows]
    mask = torch.rand(q.shape, generator=gen, device=q.device) < redrawn[:, None]
    return torch.where(mask, lattice(gen, q.shape, q.device), q)


def oracle_ranks(g: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Rank of each query's own gallery row (ties count), squared Euclidean
    distances in f64 numpy."""
    g64, q64 = g.astype(np.float64), q.astype(np.float64)
    d2 = (g64 * g64).sum(1)[:, None] + (q64 * q64).sum(1)[None, :] - 2.0 * (g64 @ q64.T)
    d_true = np.diagonal(d2)
    return (d2 <= d_true[None, :]).sum(0).astype(np.int32)


def safa_int8_embed(data_cfg, towers, batch):
    """The SAFA static-int8 serving forward: int8-first preprocessing, both
    int8 towers -> (surface, overhead) vectors [B, 4096]."""
    (sq_s, head_s), (sq_o, head_o) = towers
    surf_q, polar_q = quantize.preprocess_static_int8(data_cfg, sq_s, sq_o, batch)
    return (quantize.quantized_safa_forward_static(sq_s, head_s, surf_q, False, x_quantized=True),
            quantize.quantized_safa_forward_static(sq_o, head_o, polar_q, True, x_quantized=True))


def phase_safa_towers(card, device):
    """[23] SAFA towers at full CVUSA geometry, bf16 and static int8, and
    euclidean_ranks at 8832^2; returns launches per kernel per precision."""
    cfg = safa_experiment("cvusa", 360)
    d = cfg.data
    log(f"[23] SAFA towers, safa_experiment('cvusa', 360): {d.surface_height} x "
        f"{d.surface_width} surface, {d.overhead_size}^2 tile polar-mapped to "
        f"{d.surface_height} x {d.surface_width_max}, batch 128, random weights from a seed; "
        f"bf16 and static int8, each against the plain kernels on the card")
    pipeline = SafaPipeline(cfg, device)
    params = pipeline.init(torch.Generator().manual_seed(0))
    batch = raw_batch(np.random.default_rng(30), cfg, 128)
    launches = {}

    conv3x3.launches = 0
    s_emb, o_emb = pipeline.embed_step(params, batch)
    torch.cuda.synchronize()
    launches["bf16"] = {"conv3x3": conv3x3.launches}
    if launches["bf16"]["conv3x3"] < 1:
        raise AssertionError("the bf16 SAFA towers did not launch conv3x3_bf16")
    with plain_kernels():
        s_pl, o_pl = pipeline.embed_step(params, batch)
    for name, got, want in (("surface", s_emb, s_pl), ("overhead", o_emb, o_pl)):
        norms = got.norm(dim=1)
        err = float((got - want).abs().max())
        ok = (got.shape == (len(batch["surface"]), 4096) and bool(torch.isfinite(got).all())
              and bool(torch.isclose(norms, torch.ones_like(norms), rtol=1e-5).all())
              and bool(torch.isclose(got, want, rtol=2e-2,
                                     atol=2e-2 * float(want.abs().max())).all()))
        cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
        log(f"    bf16 {name} tower [128, 4096] vs plain kernels: max |d emb| {err:.3e} (rtol 2e-2, "
            f"atol 2e-2 max|y| = {2e-2 * float(want.abs().max()):.3e}), cosine min "
            f"{float(cos.min()):.6f}")
        if not ok:
            raise AssertionError(f"bf16 SAFA {name} tower disagrees with the plain kernels")

    calib = {k: v[:8] for k, v in batch.items()}
    s_in, p_in = pipeline.preprocess(calib)
    t0 = time.perf_counter()
    towers = quantize.quantize_safa_pipeline_static(params, [(s_in, p_in)])
    torch.cuda.synchronize()
    log(f"    calibrated both int8 trunks on 8 preprocessed samples in "
        f"{time.perf_counter() - t0:.2f} s")
    for mod in INT8_MODULES.values():
        mod.launches = 0
    s8, o8 = safa_int8_embed(d, towers, batch)
    torch.cuda.synchronize()
    launches["int8"] = {n: m.launches for n, m in INT8_MODULES.items()}
    idle = [n for n, c in launches["int8"].items() if c < 1]
    if idle:
        raise AssertionError(f"the int8 SAFA towers did not launch {idle}")
    with plain_kernels():
        s8p, o8p = safa_int8_embed(d, towers, batch)
    for name, got, want in (("surface", s8, s8p), ("overhead", o8, o8p)):
        err = float((got - want).abs().max())
        log(f"    int8 {name} tower [128, 4096] vs plain kernels (conv4_3 on the dequant "
            f"epilogue at Co 512): max |d emb| {err:.3e} (atol {INT8_ATOL})")
        if got.shape != (len(batch["surface"]), 4096) or not err <= INT8_ATOL:
            raise AssertionError(f"int8 SAFA {name} tower disagrees with the plain kernels")
    f32 = SafaPipeline(cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32")),
                       device)
    with torch.no_grad():
        s32, o32 = f32._towers(params, s_in, p_in, False, None)
        (sq_s, head_s), (sq_o, head_o) = towers
        for name, want, got in (
                ("surface", s32, quantize.quantized_safa_forward_static(sq_s, head_s, s_in, False)),
                ("overhead", o32, quantize.quantized_safa_forward_static(sq_o, head_o, p_in, True))):
            cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
            log(f"    int8 vs f32 {name} tower on the 8 calibration samples: cosine min "
                f"{float(cos.min()):.6f} (> 0.99)")
            if not bool((cos > 0.99).all()):
                raise AssertionError(f"int8 SAFA {name} tower disagrees with the f32 tower")
    log(f"    launches: bf16 {launches['bf16']}, int8 {launches['int8']}")

    # euclidean_ranks at the test set's scale, TF32 forced off for the product
    gen = torch.Generator(device=device).manual_seed(31)
    g = lattice(gen, (RANK_PAIRS, RANK_D), device)
    q = planted_queries(gen, g, torch.arange(RANK_PAIRS, device=device),
                        torch.linspace(0.0, 1.0, RANK_PAIRS, device=device))
    tf32_seen = []
    real_sq = gallery.sq_distances

    def recording_sq(*args):
        tf32_seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_sq(*args)

    gallery.sq_distances = recording_sq
    torch.backends.cuda.matmul.allow_tf32 = True  # the global flag may say anything
    try:
        gallery.euclidean_ranks(g, q)
        t0 = time.perf_counter()
        ranks = gallery.euclidean_ranks(g, q)
        t_ranks = time.perf_counter() - t0
    finally:
        gallery.sq_distances = real_sq
        torch.backends.cuda.matmul.allow_tf32 = False
    if not tf32_seen or any(tf32_seen):
        raise AssertionError(f"euclidean_ranks ran its products with TF32 allowed: {tf32_seen}")
    t0 = time.perf_counter()
    want = oracle_ranks(g.cpu().numpy(), q.cpu().numpy())
    t_oracle = time.perf_counter() - t0
    if not np.array_equal(ranks, want):
        raise AssertionError(f"euclidean_ranks differs from the f64 oracle on "
                             f"{int((ranks != want).sum())} of {RANK_PAIRS} queries")
    log(f"    euclidean_ranks, {RANK_PAIRS} planted integer-lattice pairs at D = {RANK_D}: == the "
        f"f64 numpy oracle ({t_oracle:.2f} s), mean rank {ranks.mean():.4f}, "
        f"{len(np.unique(ranks))} distinct ranks; TF32 off in all {len(tf32_seen)} products "
        f"(global flag set True around the call); {t_ranks:.4f} s (host clock, second of two "
        f"runs) ({card})")
    del g, q

    gen_in = torch.Generator(device=device).manual_seed(32)
    staged = [
        {"surface": torch.rand(128, d.surface_height, d.surface_width_max, 3,
                               generator=gen_in, device=device) * 255.0,
         "overhead": torch.rand(128, d.overhead_size, d.overhead_size, 3,
                                generator=gen_in, device=device) * 255.0}
        for _ in range(4)
    ]
    step_of = iter(range(10**9))

    def stage(fn):
        return lambda: fn(staged[next(step_of) % len(staged)])

    def bf16_step(b):
        s, o = pipeline.embed_step(params, b)
        return pairwise_sq_distances(o, s)

    def int8_step(b):
        s, o = safa_int8_embed(d, towers, b)
        return pairwise_sq_distances(o, s)

    t_bf16 = cuda_ms(stage(bf16_step), 8, 5)
    t_int8 = cuda_ms(stage(int8_step), 8, 5)
    log(f"    embed+match SAFA batch 128 (both towers, then the [128, 128] squared distances): "
        f"bf16 {t_bf16:.3f} ms/step = {128 * 1000.0 / t_bf16:.2f} pairs/s; static int8 "
        f"{t_int8:.3f} ms/step = {128 * 1000.0 / t_int8:.2f} pairs/s (CUDA events, varied "
        f"inputs, median of 5 runs of 8) ({card})")
    return launches


def phase_safa_serving(card, device, csv_path):
    """[24] build_index --family safa on [18]'s 512 tiles, VectorIndex at
    100,000 vectors, the daemon and the heatmap sweep with the SAFA towers;
    returns launches per kernel per precision, summed."""
    cfg = safa_experiment("witw", 70)
    d = cfg.data
    log(f"[24] SAFA serving, safa_experiment('witw', 70) ({d.surface_height} x {d.surface_width} "
        f"photo crop), random weights from a seed saved as `best`: build_index --family safa "
        f"on [18]'s {SERVE_TILES} tiles, VectorIndex at {INDEX_TILES} vectors, the daemon, "
        f"the heatmap sweep")
    shutil.rmtree(SAFA_DIR, ignore_errors=True)
    SAFA_DIR.mkdir(parents=True)
    weights = SAFA_DIR / "weights"
    state = SafaPipeline(cfg, device).init_state(torch.Generator().manual_seed(0))
    Checkpointer(str(weights / "safa_70_witw")).save("best", state)
    params = state.params
    counted = dict(INT8_MODULES, conv3x3=conv3x3, fused_match=fused_match)
    mods = {"bf16": ["conv3x3"], "int8": list(INT8_MODULES)}
    launches = {p: {n: 0 for n in counted} for p in mods}

    def count(precision, what):
        torch.cuda.synchronize()
        for n, m in counted.items():
            launches[precision][n] += m.launches
        idle = [n for n in mods[precision] if counted[n].launches < 1]
        if idle:
            raise AssertionError(f"{what} ({precision}) did not launch {idle}")
        if fused_match.launches:
            raise AssertionError(f"{what} ({precision}) launched the fused match")

    def reset():
        for m in counted.values():
            m.launches = 0

    # build_index --family safa
    seen = {}
    real_span = quantize.calibrate_overhead_span

    def record_span(*args, **kwargs):
        seen["sq"], items = real_span(*args, **kwargs)
        return seen["sq"], items

    indexes = {}
    quantize.calibrate_overhead_span = record_span
    try:
        for precision, flags in (("bf16", []), ("int8", ["--int8"])):
            out = SAFA_DIR / f"index_{precision}.npz"
            reset()
            t0 = time.perf_counter()
            build_index.main(["--csv", csv_path, "--out", str(out), "--weights", str(weights),
                              "--dataset", "witw", "--fov", "70", "--family", "safa",
                              "--meta-cols", "col0:x,col1:y"] + flags)
            count(precision, "build_index --family safa")
            dt = time.perf_counter() - t0
            index = VectorIndex.load(str(out), device)
            meta = index.meta
            if (index.embeds.shape != (SERVE_TILES, 4096) or not np.isfinite(index.embeds).all()
                    or str(meta["family"]) != "safa"
                    or str(meta["precision"]) != ("int8" if flags else "f32")
                    or str(meta["params_sha"]) != params_fingerprint(params["overhead"])
                    or not np.array_equal(meta["x"], 1000.0 + 10 * np.arange(SERVE_TILES))):
                raise AssertionError(f"SAFA {precision} index: embeds {index.embeds.shape}, meta "
                                     f"{ {k: str(v)[:40] for k, v in meta.items()} }")
            log(f"    build_index {precision}: {SERVE_TILES} tiles in {dt:.3f} s = "
                f"{SERVE_TILES / dt:.2f} tiles/s (host clock) ({card}); VectorIndex "
                f"{index.embeds.shape}, family 'safa'")
            check_index_build(index, cfg, params, seen.get("sq"), bool(flags))
            indexes[precision] = index
    finally:
        quantize.calibrate_overhead_span = real_span

    # VectorIndex at 100,000 vectors, resident
    gen = torch.Generator(device=device).manual_seed(33)
    t0 = time.perf_counter()
    gal = lattice(gen, (INDEX_TILES, RANK_D), device)
    planted = torch.randperm(INDEX_TILES, generator=gen, device=device)[:8]
    queries = planted_queries(gen, gal, planted,
                              torch.full((8,), 0.125, device=device)).cpu().numpy()
    embeds = gal.cpu().numpy()
    planted = planted.cpu().numpy()
    del gal
    log(f"    made {INDEX_TILES} planted integer-lattice vectors [N, {RANK_D}] in "
        f"{time.perf_counter() - t0:.2f} s ({embeds.nbytes / 1e9:.2f} GB f32)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    vindex = VectorIndex(embeds, device=device)
    i_s, d_s = vindex.search(queries, k=10)
    q64 = queries.astype(np.float64)
    d2 = np.empty((len(queries), INDEX_TILES))
    for a in range(0, INDEX_TILES, 10_000):
        g64 = embeds[a:a + 10_000].astype(np.float64)
        d2[:, a:a + 10_000] = ((q64 * q64).sum(1)[:, None] + (g64 * g64).sum(1)[None, :]
                               - 2.0 * q64 @ g64.T)
    order = np.argsort(d2, axis=1, kind="stable")[:, :10]
    want_d = np.sqrt(np.maximum(np.take_along_axis(d2, order, axis=1), 0.0))
    if not (np.array_equal(i_s, order) and np.array_equal(i_s[:, 0], planted)
            and np.allclose(d_s, want_d, rtol=1e-5, atol=1e-6)):
        raise AssertionError(f"VectorIndex.search differs from the numpy oracle: top-1 "
                             f"{i_s[:, 0]} (planted {planted})")
    scores = vindex.score_all(queries[:2])
    if not np.allclose(scores, np.sqrt(np.maximum(d2[:2].T, 0.0)), rtol=1e-5, atol=1e-6):
        raise AssertionError("VectorIndex.score_all differs from the numpy oracle")
    timings = {f"search(k=10) Q {qn}": cuda_ms(lambda qn=qn: vindex.search(queries[:qn], k=10),
                                               1, 5) for qn in (1, 8)}
    timings["score_all Q 2"] = cuda_ms(lambda: vindex.score_all(queries[:2]), 1, 5)
    peak = torch.cuda.max_memory_allocated(device) - base
    log(f"    VectorIndex {INDEX_TILES} x {RANK_D}: search(k=10) == the f64 numpy oracle's top-10 "
        f"(indices, ties to the lower index; distances within rtol 1e-5), top-1 == planted, "
        f"resident score_all == the oracle; " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                                     timings.items())
        + f" (CUDA events, median of 5); peak device memory {peak / 1e9:.3f} GB above the "
        f"baseline ({card})")
    del vindex, embeds
    torch.cuda.empty_cache()

    # the daemon
    rng = np.random.default_rng(34)
    photos = [png_bytes(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
              for _ in range(SAFA_REQUESTS)]
    for precision, int8 in (("bf16", False), ("int8", True)):
        index = indexes[precision]
        service = serve_tool.GeolocateService(index, cfg, params, int8=int8, max_batch=8,
                                              family="safa")
        seen_embeds = []
        real_embed = service._embed

        def recording_embed(imgs, real_embed=real_embed, seen=seen_embeds):
            out = real_embed(imgs)
            seen.append((imgs, out))
            return out

        service._embed = recording_embed
        server = serve_tool.serve(service, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            service.warmup()
            seen_embeds.clear()
            reset()
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                answers = list(pool.map(lambda p: http_json(f"{url}/geolocate?k=5", p), photos))
            wall = time.perf_counter() - t0
            count(precision, "the SAFA daemon")
            approx, _ = http_json(f"{url}/geolocate?k=5&candidates=64", photos[0])
            health, _ = http_json(f"{url}/healthz")
            stats, _ = http_json(f"{url}/stats")
            direct = []
            for imgs, embs in seen_embeds[:-1]:
                i_d, d_d = index.search(embs, k=service._k_bucket(5))
                direct += [(imgs[r], i_d[r, :5], d_d[r, :5]) for r in range(len(imgs))]
            for photo, (out, _) in zip(photos, answers):
                img = service._decode(photo)
                _, i_d, d_d = next(t for t in direct if np.array_equal(t[0], img))
                res = out["results"]
                if ([r["tile"] for r in res] != i_d.tolist()
                        or [r["distance"] for r in res] != [float(v) for v in d_d]
                        or any(r["orientation_deg"] is not None for r in res)
                        or [r["x"] for r in res] != [1000.0 + 10 * t for t in i_d]
                        or [r["score"] for r in res]
                        != [float(np.exp(10.0 * (1.0 - v))) for v in d_d]):
                    raise AssertionError(f"{precision} SAFA daemon answer differs from the "
                                         f"direct search")
            batches, worst = check_daemon_embeds(service, seen_embeds, int8)
            if (len(approx["results"]) != 5 or stats["requests"] != SAFA_REQUESTS + 1
                    or stats["errors"] != 0 or stats["approx_searches"] != 0
                    or health["family"] != "safa" or health["int8"] != int8):
                raise AssertionError(f"{precision} SAFA daemon: stats {stats}, health {health}")
            p50, p99 = (1e3 * float(np.percentile([t for _, t in answers], q)) for q in (50, 99))
            log(f"    daemon {precision}: {SAFA_REQUESTS} requests in {wall:.3f} s = "
                f"{SAFA_REQUESTS / wall:.2f} requests/s, latency p50 {p50:.2f} ms, p99 "
                f"{p99:.2f} ms (host clock, 8 clients) ({card}); mean batch "
                f"{stats['mean_batch']}; every answer == VectorIndex.search on the daemon's "
                f"embeddings, orientation null; those embeddings (batches {batches}) vs the "
                f"plain kernels: {'max |d emb|' if int8 else 'cosine min'} {worst:.6g}; "
                f"candidates=64 searched exactly")
        finally:
            server.shutdown()
            server.server_close()
            service.close()

    # the heatmap sweep
    t0 = time.perf_counter()
    bounds, side = write_strip(SAFA_DIR, SAFA_SWEEP_SIDE)
    photo_paths = []
    for k in range(2):
        photo_paths.append(str(SAFA_DIR / f"photo{k}.png"))
        (SAFA_DIR / f"photo{k}.png").write_bytes(
            png_bytes(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)))
    log(f"    wrote a {side} x {side} x 3 strip for a {SAFA_SWEEP_SIDE} x {SAFA_SWEEP_SIDE} grid "
        f"in {time.perf_counter() - t0:.2f} s")
    _, _, windows = heatmap.window_grid(bounds, 225.0, 56.25)
    with geotiff.GeoTiff(str(SAFA_DIR / "03_paris.tif")) as sat:
        first_tiles = np.stack([geotiff.resample(sat.read_world_window(*w).astype(np.float32),
                                                 d.overhead_size, d.overhead_size)
                                for w in windows[:8]])
    cache = SAFA_DIR / "tiles.npz"
    n = SAFA_SWEEP_SIDE ** 2
    real_score = VectorIndex.score_all

    def record_score(index, query_embeds, *args, **kwargs):
        seen["s_emb"] = np.array(query_embeds)
        return real_score(index, query_embeds, *args, **kwargs)

    quantize.calibrate_overhead_span = record_span
    VectorIndex.score_all = record_score
    try:
        for precision, flags in (("bf16", []), ("int8", ["--int8"])):
            argv = (["-a", "3", "-b", *map(str, bounds), "-s", str(SAFA_DIR), "-p", *photo_paths,
                     "--weights", str(weights), "--family", "safa", "--index-cache", str(cache)]
                    + flags)
            runs = {}
            for run in ("cold", "warm"):
                reset()
                t0 = time.perf_counter()
                heatmap.main(argv + ["-c", str(SAFA_DIR / f"{precision}_{run}.csv")])
                count(precision, f"the {run} SAFA sweep")
                runs[run] = time.perf_counter() - t0
            header, cold = read_sweep_csv(SAFA_DIR / f"{precision}_cold.csv")
            _, warm = read_sweep_csv(SAFA_DIR / f"{precision}_warm.csv")
            if header != ["photo", "x", "y", "dissimilarity", "score"] or len(cold) != 2 * n \
                    or warm != cold:
                raise AssertionError(f"SAFA {precision} CSV: header {header}, {len(cold)} rows")
            d_col = np.asarray([r[3] for r in cold], np.float32)
            score = np.asarray([r[4] for r in cold], np.float32)
            if not (np.isfinite(d_col).all()
                    and np.allclose(score, np.exp(10.0 * (1.0 - d_col)), rtol=1e-6, atol=0)):
                raise AssertionError(f"SAFA {precision}: scores are not exp(10 (1 - d))")
            index = VectorIndex.load(str(cache), device)
            if (len(index) != n or str(index.meta["family"]) != "safa"
                    or str(index.meta["precision"]) != ("int8" if flags else "f32")):
                raise AssertionError(f"SAFA {precision} cache: {len(index)} tiles, meta "
                                     f"{ {k: str(v)[:40] for k, v in index.meta.items()} }")
            check_index_build(index, cfg, params, seen.get("sq"), bool(flags), first_tiles)
            dd = float(np.abs(real_score(index, seen["s_emb"][:1])[:, 0] - d_col[:n]).max())
            if not dd <= 1e-6:
                raise AssertionError(f"SAFA {precision}: photo 0's rows differ from score_all "
                                     f"({dd})")
            log(f"    heatmap --family safa {precision}: {n} tiles cold {runs['cold']:.3f} s = "
                f"{n / runs['cold']:.2f} tiles/s (arguments to CSV, host clock), warm (cache "
                f"hit) {runs['warm']:.3f} s ({card}); {len(cold)} rows == warm rows, no "
                f"orientation column, score == exp(10 (1 - d)), photo 0's rows == "
                f"VectorIndex.score_all (max |dd| {dd:.3e})")
    finally:
        quantize.calibrate_overhead_span = real_span
        VectorIndex.score_all = real_score
        shutil.rmtree(SAFA_DIR, ignore_errors=True)
    log(f"    launches, build + daemon + sweeps: { {p: {k: v for k, v in c.items() if v} for p, c in launches.items()} }")
    return launches


def phase_safa_cli(card, device):
    """[25] cli.cvig_safa.main at full CVUSA width: train one epoch, then
    test; returns launches per kernel per run."""
    log(f"[25] cli.cvig_safa.main --dataset cvusa --fov 360 (batch 32): --mode train --epochs 1 "
        f"on {SAFA_CLI_PAIRS} synthetic pairs ({SAFA_CLI_PAIRS - SAFA_CLI_VAL} train, "
        f"val_quantity {SAFA_CLI_VAL} by wrapping run_train), then --mode test")
    shutil.rmtree(SAFA_DIR, ignore_errors=True)
    SAFA_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    csv_path = write_cli_dataset(SAFA_DIR / "data", SAFA_CLI_PAIRS)
    log(f"    wrote the dataset in {time.perf_counter() - t0:.2f} s")
    flags = ["--dataset", "cvusa", "--fov", "360", "--train-csv", csv_path, "--test-csv", csv_path]
    real_run_train = cli_common.run_train

    def run_train_small_val(cfg, tag, num_epochs=None, profile_dir=None, device=None):
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, val_quantity=SAFA_CLI_VAL))
        return real_run_train(cfg, tag, num_epochs=num_epochs, profile_dir=profile_dir,
                              device=device)

    counted = {"conv3x3": conv3x3, "fused_match": fused_match}
    launches, results = {}, {}
    cwd = os.getcwd()
    os.chdir(SAFA_DIR)
    cli_common.run_train = run_train_small_val
    try:
        for run, argv in (("train", ["--mode", "train", "--epochs", "1"]),
                          ("test", ["--mode", "test"])):
            for mod in counted.values():
                mod.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                results[run] = cvig_safa.main(argv + flags)
            torch.cuda.synchronize()
            launches[run] = {n: mod.launches for n, mod in counted.items()}
            log(f"    {run}: {time.perf_counter() - t0:.2f} s (host clock, arguments to return); "
                f"launches {launches[run]}")
            if launches[run]["conv3x3"] < 1 or launches[run]["fused_match"]:
                raise AssertionError(f"cvig_safa {run}: launches {launches[run]}")
        weights = SAFA_DIR / "weights" / "safa_360_cvusa"
        if not ((weights / "best.pt").exists() and (weights / "latest.pt").exists()):
            raise AssertionError(f"no best.pt / latest.pt in {weights}")
        cfg = cli_common.apply_overrides(safa_experiment("cvusa", 360),
                                         cli_common.base_parser(True).parse_args(flags))
        records = [json.loads(line) for line in
                   (SAFA_DIR / "runs" / "safa_360_cvusa" / "train" / "metrics.jsonl").read_text()
                   .splitlines()]
        tags = {r["tag"] for r in records}
        losses = [r["value"] for r in records if r["tag"] in ("train loss", "val loss")]
        steps = ((SAFA_CLI_PAIRS - SAFA_CLI_VAL) // cfg.train.batch_size
                 + -(-SAFA_CLI_VAL // cfg.train.batch_size))
        if (not {"train loss", "val loss", "train pairs_per_sec", "best_loss"} <= tags
                or "val_embedding" in tags or len(losses) != steps
                or not np.isfinite(losses).all()):
            raise AssertionError(f"train metrics.jsonl: tags {tags}, losses {losses}")
        cli_rate = next(r["value"] for r in records if r["tag"] == "train pairs_per_sec")
        pipeline = SafaPipeline(cfg, device)
        params = Checkpointer(str(weights)).restore(
            "best", pipeline.init_state(torch.Generator().manual_seed(0))).params
        test_loader = cli_common.build_loader(
            cfg, read_pair_paths(cfg.data.dataset, csv_path), shuffle=False, drop_last=False,
            batch_size=cfg.eval.batch_size)
        try:
            direct = loop.test(cfg, pipeline, test_loader, params, verbose=False)
        finally:
            test_loader.close()
        if direct != results["test"] or direct["locations"] != SAFA_CLI_PAIRS:
            raise AssertionError(f"test mode {results['test']} != loop.test {direct}")
        log(f"    losses finite {[round(v, 5) for v in losses]}; best.pt, latest.pt; no "
            f"embedding dump; test {json.dumps(results['test'])} == loop.test on the restored "
            f"best (euclidean_ranks); train {cli_rate:.2f} pairs/s (the loop's StepTimer, host "
            f"clock) ({card})")
    finally:
        cli_common.run_train = real_run_train
        os.chdir(cwd)
        shutil.rmtree(SAFA_DIR, ignore_errors=True)
    return launches


# --- the baseline family (phases 26-28) --------------------------------------

BASE_DIR = Path(__file__).resolve().parent / ".smoke_baseline"
BASE_BATCH = 16  # the preset's train and eval batch
BASE_D = 1536
BASE_REQUESTS = 16
BASE_SWEEP_SIDE = 50  # 2,500 tiles, [24]'s cut
BASE_CLI_PAIRS, BASE_CLI_VAL = 160, 32  # 8 train and 2 val steps at batch 16; 10 test batches
BASE_F32_RTOL, BASE_F32_ATOL = 1e-4, 1e-5  # the card's f32 towers against the CPU's
BASE_INT8_RTOL = 1e-5  # the int8 towers, card against CPU: GeM's means sum in another order
PROFILE_STEPS = 4


BASELINE_LAUNCHES = collections.Counter()  # kernel launches seen on the baseline path


def kernel_counts():
    """Launch counts of every hand-written kernel of the port, by the names
    of the kernels line's records' counters."""
    counts = {"fused_match": fused_match.launches, "conv3x3": conv3x3.launches,
              "conv_like": sum(int8_isolate.launches.values()),
              "mm_s8": int8_mm_probe.launches["mm"], "mm_bf16": int8_mm_probe.launches["mmf"],
              "caps": sum(mosaic_caps.launches.values())}
    counts.update({n: m.launches for n, m in INT8_MODULES.items()})
    return counts


def reset_kernel_counts():
    fused_match.launches = conv3x3.launches = 0
    for mod in INT8_MODULES.values():
        mod.launches = 0
    for mod in (int8_isolate, int8_mm_probe, mosaic_caps):
        for k in mod.launches:
            mod.launches[k] = 0


def check_no_kernel(what):
    """The baseline path runs cuDNN, cuBLAS(Lt) and PyTorch ops only: fail
    if any hand-written kernel launched since the last reset."""
    torch.cuda.synchronize()
    launched = {n: c for n, c in kernel_counts().items() if c}
    BASELINE_LAUNCHES.update(launched)
    if launched:
        raise AssertionError(f"{what} launched the port's kernels {launched}")


def baseline_batch(rng, cfg, b, surface_hw=None):
    """Raw uint8-scale float NHWC at the baseline's host geometry."""
    surface_hw, overhead_hw = cli_common.host_geometry(cfg) if surface_hw is None else (
        surface_hw, (750, 750))
    return {"surface": rng.uniform(0, 255, (b, *surface_hw, 3)).astype(np.float32),
            "overhead": rng.uniform(0, 255, (b, *overhead_hw, 3)).astype(np.float32)}


def staged_batches(cfg, device, seed, n=4):
    """``n`` varied raw batches of BASE_BATCH, made on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    surface_hw, overhead_hw = cli_common.host_geometry(cfg)
    return [{"surface": torch.rand(BASE_BATCH, *surface_hw, 3, generator=gen, device=device) * 255,
             "overhead": torch.rand(BASE_BATCH, *overhead_hw, 3, generator=gen, device=device) * 255}
            for _ in range(n)]


def rotation_tie_pixels(got, want, degrees):
    """Pixels where two rotations of the same tiles differ; raise unless
    each samples a source coordinate within 1e-4 of a rounding tie."""
    differ = np.argwhere((got != want).any(-1))
    s = got.shape[1]
    c = (s - 1) / 2.0
    theta = degrees.astype(np.float64) * np.pi / 180.0
    for n, i, j in differ:
        sx = np.cos(theta[n]) * (j - c) - np.sin(theta[n]) * (i - c) + c
        sy = np.sin(theta[n]) * (j - c) + np.cos(theta[n]) * (i - c) + c
        if min(abs(abs(sx - np.floor(sx)) - 0.5), abs(abs(sy - np.floor(sy)) - 0.5)) >= 1e-4:
            raise AssertionError(f"rotated pixel {(n, i, j)} differs away from a rounding tie")
    return len(differ)


def baseline_int8_embed(towers, s_in, o_in):
    (sq_s, sq_o) = towers
    return (quantize.quantized_baseline_forward_static(sq_s, s_in),
            quantize.quantized_baseline_forward_static(sq_o, o_in))


def int8_card_vs_cpu(sq, x, device):
    """One int8 tower on the card and on the CPU with the same tables:
    (every layer's int32 accumulators equal, or raise; the largest
    |d emb| / |emb|; the last accumulator's shape)."""
    accs, outs = {"card": [], "cpu": []}, {}
    real_acc = quantize.conv4x4s2_int8_acc
    sq_cpu = quantize.static_qparams_to_device(sq, "cpu")
    try:
        for where, tables, inputs in (("card", sq, x.to(device)), ("cpu", sq_cpu, x.cpu())):
            def record(h, kernel_mm, seen=accs[where]):
                out = real_acc(h, kernel_mm)
                seen.append(out.cpu())
                return out

            quantize.conv4x4s2_int8_acc = record
            outs[where] = quantize.quantized_baseline_forward_static(tables, inputs).cpu()
    finally:
        quantize.conv4x4s2_int8_acc = real_acc
    got, want = outs["card"], outs["cpu"]
    for i, (g, w) in enumerate(zip(accs["card"], accs["cpu"]), 1):
        if not torch.equal(g, w):
            raise AssertionError(f"conv{i}'s int32 accumulators differ between the card and the CPU")
    if not torch.allclose(got, want, rtol=BASE_INT8_RTOL, atol=1e-6):
        raise AssertionError(f"int8 baseline tower: card vs CPU max |d emb| "
                             f"{float((got - want).abs().max())}")
    return (float(((got - want).abs() / want.abs().clamp_min(1e-12)).max()),
            tuple(accs["card"][-1].shape))


def phase_baseline_towers(card, device):
    """[26] baseline towers at full CVUSA width in f32 and bf16, 4 train
    steps, euclidean_ranks at 8832^2, D 1536; returns (params, pipeline,
    timings)."""
    cfg = baseline_experiment("cvusa")
    surface_hw, overhead_hw = cli_common.host_geometry(cfg)
    log(f"[26] baseline towers, baseline_experiment('cvusa'): {surface_hw[0]} x {surface_hw[1]} "
        f"surface (rows repeated to {2 * surface_hw[0]} x {surface_hw[1]} on the card), raw "
        f"{overhead_hw[0]}^2 tiles, batch {BASE_BATCH}, random weights from a seed; cuDNN convs, "
        f"no kernel of the port")
    reset_kernel_counts()
    pipeline = BaselinePipeline(cfg, device)
    params = pipeline.init(torch.Generator().manual_seed(0))
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    p32, cpu32 = BaselinePipeline(cfg32, device), BaselinePipeline(cfg32, "cpu")
    cpu_params = {t: {k: v.cpu() for k, v in p.items()} for t, p in params.items()}
    rng = np.random.default_rng(40)
    two = baseline_batch(rng, cfg, 2)
    degrees = rotation.rotation_degrees(torch.Generator().manual_seed(41), 2).numpy()
    s_gpu, o_gpu = p32.preprocess(two, torch.Generator().manual_seed(41))
    s_cpu, o_cpu = cpu32.preprocess(two, torch.Generator().manual_seed(41))
    if not torch.equal(s_gpu.cpu(), s_cpu):
        raise AssertionError("the rolled, row-repeated surfaces differ between the card and the CPU")
    ties = rotation_tie_pixels(o_gpu.cpu().numpy(), o_cpu.numpy(), degrees)
    with torch.no_grad():
        want = cpu32._towers(cpu_params, s_cpu, o_cpu, False, None)
        got = p32._towers(params, s_cpu.to(device), o_cpu.to(device), False, None)
    for name, g, w in zip(("surface", "overhead"), got, want):
        g = g.cpu()
        rel = float(((g - w).abs() / w.abs().clamp_min(1e-12)).max())
        log(f"    f32 {name} tower, card (TF32 off) vs CPU, 2 samples: max |d emb| "
            f"{float((g - w).abs().max()):.3e}, max rel {rel:.3e} (rtol {BASE_F32_RTOL}, atol "
            f"{BASE_F32_ATOL})")
        if not torch.allclose(g, w, rtol=BASE_F32_RTOL, atol=BASE_F32_ATOL):
            raise AssertionError(f"the card's f32 baseline {name} tower disagrees with the CPU's")
    log(f"    preprocess card vs CPU: surfaces equal; rotated tiles differ at {ties} of "
        f"{o_cpu.shape[0] * o_cpu.shape[1] * o_cpu.shape[2]} pixels, each at a rounding tie")

    batch = baseline_batch(rng, cfg, BASE_BATCH)
    s_in, o_in = pipeline.preprocess(batch, torch.Generator().manual_seed(43))
    with torch.no_grad():
        e16 = pipeline._towers(params, s_in, o_in, False, None)
        e32 = p32._towers(params, s_in, o_in, False, None)
    for name, g, w in zip(("surface", "overhead"), e16, e32):
        cos = torch.nn.functional.cosine_similarity(g, w, dim=1)
        log(f"    bf16 vs f32 {name} tower [{BASE_BATCH}, {BASE_D}]: cosine min "
            f"{float(cos.min()):.6f} (>= 0.999)")
        if g.shape != (BASE_BATCH, BASE_D) or not bool((cos >= 0.999).all()):
            raise AssertionError(f"the bf16 baseline {name} tower disagrees with f32")
    check_no_kernel("the baseline towers")

    train_params = {t: {k: v.clone() for k, v in p.items()} for t, p in params.items()}
    state = TrainState(0, train_params, pipeline.optimizer(train_params))
    staged = staged_batches(cfg, device, 44)
    gen = torch.Generator().manual_seed(45)
    losses = []
    for b in staged:
        state, metrics = pipeline.train_step(state, b, gen)
        losses.append(float(metrics["loss"]))
    moved = [k for k in train_params["overhead"] if "running" in k
             and not torch.equal(train_params["overhead"][k], params["overhead"][k])]
    if not np.isfinite(losses).all() or len(moved) != 14:
        raise AssertionError(f"train steps: losses {losses}, running stats moved {moved}")
    log(f"    4 train steps at batch {BASE_BATCH}: losses {[round(v, 5) for v in losses]}, all 14 "
        f"BatchNorm buffers of a tower moved")
    check_no_kernel("the baseline train steps")

    step_of = iter(range(10**9))

    def stage(fn):
        return lambda: fn(staged[next(step_of) % len(staged)])

    def bf16_step(b):
        s, o = pipeline.embed_step(params, b)
        return pairwise_sq_distances(o, s)

    def train_once():
        pipeline.train_step(state, staged[next(step_of) % len(staged)], gen)

    timings = {"bf16": cuda_ms(stage(bf16_step), 8, 5), "train": cuda_ms(train_once, 4, 5)}
    log(f"    embed+match bf16 batch {BASE_BATCH} (rotation, both towers, the [{BASE_BATCH}, "
        f"{BASE_BATCH}] squared distances): {timings['bf16']:.3f} ms/step = {BASE_BATCH * 1000.0 / timings['bf16']:.2f} "
        f"pairs/s; train step {timings['train']:.3f} ms/step = "
        f"{BASE_BATCH * 1000.0 / timings['train']:.2f} pairs/s (CUDA events, varied inputs, "
        f"median of 5) ({card})")
    check_no_kernel("the baseline timing")
    del state, train_params

    gen = torch.Generator(device=device).manual_seed(46)
    g = lattice(gen, (RANK_PAIRS, BASE_D), device)
    q = planted_queries(gen, g, torch.arange(RANK_PAIRS, device=device),
                        torch.linspace(0.0, 1.0, RANK_PAIRS, device=device))
    gallery.euclidean_ranks(g, q)
    t0 = time.perf_counter()
    ranks = gallery.euclidean_ranks(g, q)
    t_ranks = time.perf_counter() - t0
    want = oracle_ranks(g.cpu().numpy(), q.cpu().numpy())
    if not np.array_equal(ranks, want):
        raise AssertionError(f"euclidean_ranks at D {BASE_D} differs from the f64 oracle on "
                             f"{int((ranks != want).sum())} of {RANK_PAIRS} queries")
    log(f"    euclidean_ranks, {RANK_PAIRS} planted integer-lattice pairs at D = {BASE_D}: == the "
        f"f64 numpy oracle, mean rank {ranks.mean():.4f}; {t_ranks:.4f} s (host clock, second "
        f"of two runs) ({card})")
    timings["ranks"] = t_ranks
    return pipeline, params, timings


def phase_baseline_int8(card, device, pipeline, params):
    """[27] the baseline static-int8 towers: calibration on 8 samples,
    against f32, card against CPU, the padded-M case, embed pairs/s;
    returns (the tables, the int8 step's ms)."""
    cfg = pipeline.cfg
    log(f"[27] baseline static int8 (im2col of strided views + torch._int_mm, f32 epilogue): "
        f"both towers calibrated on 8 preprocessed samples")
    reset_kernel_counts()
    rng = np.random.default_rng(50)
    calib = baseline_batch(rng, cfg, 8)
    s8, o8 = pipeline.preprocess(calib, torch.Generator().manual_seed(51))
    t0 = time.perf_counter()
    towers = quantize.quantize_baseline_pipeline_static(params, [(s8, o8)])
    torch.cuda.synchronize()
    log(f"    calibrated and folded both towers in {time.perf_counter() - t0:.2f} s")
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    p32 = BaselinePipeline(cfg32, device)
    with torch.no_grad():
        f32 = p32._towers(params, s8, o8, False, None)
        q8 = baseline_int8_embed(towers, s8, o8)
    for name, sq, x, got, want in zip(("surface", "overhead"), towers, (s8, o8), q8, f32):
        cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
        norm_rel = float(((got.norm(dim=1) - want.norm(dim=1)).abs() / want.norm(dim=1)).max())
        sat = quantize.static_int8_saturation_baseline(sq, x)
        log(f"    int8 vs f32 {name} tower on the 8 calibration samples: cosine min "
            f"{float(cos.min()):.6f} (> 0.99), pseudo-norm max rel {norm_rel:.4f} (< 0.05), "
            f"saturation {sat:.3e} (< 0.01)")
        if not (bool((cos > 0.99).all()) and norm_rel < 0.05 and sat < 0.01):
            raise AssertionError(f"the int8 baseline {name} tower breaks witw_tpu's contract")
        rel, last = int8_card_vs_cpu(sq, x[:2], device)
        log(f"    int8 {name} tower, card vs CPU on 2 samples, the same tables: every layer's "
            f"int32 accumulators equal (conv7 {last}), embeddings max rel {rel:.3e}")
    witw = baseline_experiment("witw")
    photo = torch.from_numpy(baseline_batch(rng, witw, 1)["surface"])
    rel, last = int8_card_vs_cpu(towers[0], photo, device)
    if last[:3] != (1, 1, 1):
        raise AssertionError(f"a WITW 500^2 photo at batch 1 gave conv7 {last}")
    log(f"    batch 1 at WITW 500^2: conv7's GEMM has M = 1 (padded to 17 rows), accumulators "
        f"equal, embeddings max rel {rel:.3e}")
    check_no_kernel("the int8 baseline towers")

    staged = staged_batches(cfg, device, 52)
    step_of = iter(range(10**9))

    def int8_step():
        b = staged[next(step_of) % len(staged)]
        s, o = pipeline.preprocess(b)
        s_emb, o_emb = baseline_int8_embed(towers, s, o)
        return pairwise_sq_distances(o_emb, s_emb)

    t_int8 = cuda_ms(int8_step, 8, 5)
    log(f"    embed+match static int8 batch {BASE_BATCH}: {t_int8:.3f} ms/step = "
        f"{BASE_BATCH * 1000.0 / t_int8:.2f} pairs/s (CUDA events, varied inputs, median of 5) "
        f"({card})")
    check_no_kernel("the int8 baseline timing")
    return towers, t_int8


def top_op_device_us(run, steps):
    """torch.profiler over ``steps`` calls of ``run``: device microseconds
    per outermost PyTorch op (each kernel counted under the op that
    launched it, then that op's outermost caller), and the device events'
    total."""
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    by_op = collections.defaultdict(float)
    device_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_us += e.time_range.elapsed_us()
        elif e.kernels:
            top = e
            while top.cpu_parent is not None:
                top = top.cpu_parent
            by_op[top.name] += sum(k.duration for k in e.kernels)
    return by_op, device_us


def phase_baseline_profile(card, device, pipeline, params, towers):
    """The device profile of one bf16 and one int8 embed step at batch 16:
    the shares of the convs, the BatchNorm / LeakyReLU / GeM passes, the
    rotation gather; for int8, im2col, torch._int_mm and the epilogue."""
    log(f"[27] device profile (torch.profiler, {PROFILE_STEPS} steps each) of one embed+match "
        f"step at batch {BASE_BATCH}, bf16 and int8, by stage and by outermost PyTorch op")
    reset_kernel_counts()
    b = staged_batches(pipeline.cfg, device, 53, n=1)[0]
    with torch.no_grad():
        s_in, o_in = pipeline.preprocess(b)
        s_emb, o_emb = pipeline._towers(params, s_in, o_in, False, None)
    stages = {
        "preprocess": lambda: pipeline.preprocess(b),
        "towers bf16": lambda: pipeline._towers(params, s_in, o_in, False, None),
        "towers int8": lambda: baseline_int8_embed(towers, s_in, o_in),
        "distances": lambda: pairwise_sq_distances(o_emb, s_emb),
    }
    groups = {  # stage: (outermost op -> group)
        "preprocess": lambda op: "rotation gather" if op == "aten::index" else
        "rest of preprocess (rotation indices, roll, row repeat)",
        "towers bf16": lambda op: "cuDNN convs" if op in ("aten::conv2d", "aten::convolution")
        else "BatchNorm / LeakyReLU / GeM passes and casts",
        "towers int8": lambda op: {"aten::_int_mm": "torch._int_mm (cuBLASLt)",
                                   "aten::reshape": "im2col copies",
                                   "aten::cat": "im2col copies"}.get(
            op, "epilogue, input quantization, GeM"),
        "distances": lambda op: "distances",
    }
    report = {}
    with torch.no_grad():
        for stage, run in stages.items():
            by_op, device_us = top_op_device_us(run, PROFILE_STEPS)
            attributed = sum(by_op.values())
            if device_us <= 0:
                raise AssertionError(f"torch.profiler recorded no device time for {stage}")
            g = collections.defaultdict(float)
            if attributed < 0.5 * device_us:  # the profiler did not tie kernels to their ops
                g[f"{stage} (not attributed to ops)"] = device_us / PROFILE_STEPS / 1e3
            for op, us in by_op.items():
                if attributed >= 0.5 * device_us:
                    g[groups[stage](op)] += us / PROFILE_STEPS / 1e3
            report[stage] = (dict(g), device_us / PROFILE_STEPS / 1e3, attributed / device_us,
                             sorted(by_op.items(), key=lambda kv: -kv[1])[:6])
    for path, tower in (("bf16", "towers bf16"), ("int8", "towers int8")):
        parts = {}
        for stage in ("preprocess", tower, "distances"):
            parts.update(report[stage][0])
        total = sum(parts.values())
        log(f"    {path} embed+match step: {total:.3f} ms of device time ({card}); shares: "
            + "; ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                        for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))
    for stage, (_, ms, covered, top) in report.items():
        log(f"    {stage}: {ms:.3f} ms device time per step, {100 * covered:.1f}% attributed to "
            f"ops; top ops " + ", ".join(f"{op} {us / PROFILE_STEPS / 1e3:.3f}" for op, us in top))
    check_no_kernel("the profiled baseline steps")
    return report


def write_baseline_cli_dataset(directory: Path, n: int, shards: int = 8) -> str:
    """A WITW-schema CSV of n synthetic pairs (250^2 photos, 375^2 tiles:
    the loader resizes them to the baseline's 500^2 and 750^2), written in
    ``shards`` parts at once."""
    def part(k):
        return synthetic.write_synthetic_dataset(
            str(directory / f"part{k}"), n=n // shards, schema="witw", surface_hw=(250, 250),
            overhead_hw=(375, 375), seed=200 + k)

    with concurrent.futures.ThreadPoolExecutor(shards) as pool:
        parts = list(pool.map(part, range(shards)))
    header, rows = None, []
    for k, csv_part in enumerate(parts):
        with open(csv_part) as f:
            header, *lines = f.read().splitlines()
        rows += [line.replace("surface/", f"part{k}/surface/").replace("overhead/", f"part{k}/overhead/")
                 for line in lines]
    path = directory / "pairs.csv"
    path.write_text("\n".join([header] + rows) + "\n")
    return str(path)


def phase_baseline_serving(card, device, csv_path):
    """[28] at baseline_experiment('witw'): build_index --family baseline
    on [18]'s 512 tiles (bf16, int8), a 100,000 x 1536 VectorIndex, the
    daemon, the 2,500-tile heatmap sweep, cli.cvig_baseline train and test;
    none launching a kernel of the port."""
    cfg = baseline_experiment("witw")
    log(f"[28] baseline serving and CLI, baseline_experiment('witw') (500^2 photos, raw 750^2 "
        f"tiles), random weights from a seed saved as `best`: build_index --family baseline on "
        f"[18]'s {SERVE_TILES} tiles, VectorIndex at {INDEX_TILES} x {BASE_D}, the daemon, the "
        f"heatmap sweep, cli.cvig_baseline")
    shutil.rmtree(BASE_DIR, ignore_errors=True)
    BASE_DIR.mkdir(parents=True)
    reset_kernel_counts()
    weights = BASE_DIR / "weights"
    state = BaselinePipeline(cfg, device).init_state(torch.Generator().manual_seed(0))
    Checkpointer(str(weights / "baseline_70_witw")).save("best", state)
    params = state.params
    model = BaselineEncoder(cfg.model).to(device).eval()
    seen = {}
    real_span = quantize.calibrate_overhead_span

    def record_span(*args, **kwargs):
        seen["sq"], items = real_span(*args, **kwargs)
        return seen["sq"], items

    def check_vectors(got, want, int8, what):
        """bf16 cosine >= 0.999 per vector; int8 (the same tables) within
        rtol 1e-5, atol 1e-6."""
        got = torch.as_tensor(got, device=device).reshape(want.shape)
        if int8:
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=BASE_INT8_RTOL, atol=1e-6))
        else:
            err = float(torch.nn.functional.cosine_similarity(got, want, dim=1).min())
            ok = err >= 0.999
        if not ok:
            raise AssertionError(f"{what}: {'max |d emb|' if int8 else 'cosine min'} {err}")
        return err

    # build_index --family baseline
    indexes = {}
    quantize.calibrate_overhead_span = record_span
    try:
        for precision, flags in (("bf16", []), ("int8", ["--int8"])):
            out = BASE_DIR / f"index_{precision}.npz"
            t0 = time.perf_counter()
            build_index.main(["--csv", csv_path, "--out", str(out), "--weights", str(weights),
                              "--dataset", "witw", "--family", "baseline",
                              "--meta-cols", "col0:x,col1:y"] + flags)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check_no_kernel(f"build_index --family baseline ({precision})")
            index = VectorIndex.load(str(out), device)
            meta = index.meta
            if (index.embeds.shape != (SERVE_TILES, BASE_D) or not np.isfinite(index.embeds).all()
                    or str(meta["family"]) != "baseline"
                    or str(meta["precision"]) != ("int8" if flags else "f32")
                    or str(meta["params_sha"]) != params_fingerprint(params["overhead"])
                    or not np.array_equal(meta["x"], 1000.0 + 10 * np.arange(SERVE_TILES))):
                raise AssertionError(f"baseline {precision} index: embeds {index.embeds.shape}, "
                                     f"meta { {k: str(v)[:40] for k, v in meta.items()} }")
            tiles = np.stack([loader.resize_host(loader.decode_image(p)[..., :3], 750, 750)
                              for p in meta["path"][:8]])
            x = torch.from_numpy(tiles).to(device)
            with torch.no_grad():
                want = (quantize.quantized_baseline_forward_static(seen["sq"], x) if flags
                        else functional_call(model, params["overhead"], (x,), strict=True))
            err = check_vectors(index.embeds[:8], want, bool(flags), f"baseline {precision} index")
            log(f"    build_index --family baseline {precision}: {SERVE_TILES} tiles in {dt:.3f} s "
                f"= {SERVE_TILES / dt:.2f} tiles/s (decode, resize to 750^2, upload, embed; host "
                f"clock) ({card}); VectorIndex {index.embeds.shape}; first 8 vectors vs the tower "
                f"on the same tiles: {'max |d emb|' if flags else 'cosine min'} {err:.6g}")
            indexes[precision] = index
    finally:
        quantize.calibrate_overhead_span = real_span

    # VectorIndex at 100,000 x 1536, resident
    gen = torch.Generator(device=device).manual_seed(54)
    gal = lattice(gen, (INDEX_TILES, BASE_D), device)
    planted = torch.randperm(INDEX_TILES, generator=gen, device=device)[:8]
    queries = planted_queries(gen, gal, planted,
                              torch.full((8,), 0.125, device=device)).cpu().numpy()
    embeds, planted = gal.cpu().numpy(), planted.cpu().numpy()
    del gal
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    vindex = VectorIndex(embeds, device=device)
    i_s, d_s = vindex.search(queries, k=10)
    q64 = queries.astype(np.float64)
    d2 = np.empty((len(queries), INDEX_TILES))
    for a in range(0, INDEX_TILES, 10_000):
        g64 = embeds[a:a + 10_000].astype(np.float64)
        d2[:, a:a + 10_000] = ((q64 * q64).sum(1)[:, None] + (g64 * g64).sum(1)[None, :]
                               - 2.0 * q64 @ g64.T)
    order = np.argsort(d2, axis=1, kind="stable")[:, :10]
    want_d = np.sqrt(np.maximum(np.take_along_axis(d2, order, axis=1), 0.0))
    if not (np.array_equal(i_s, order) and np.array_equal(i_s[:, 0], planted)
            and np.allclose(d_s, want_d, rtol=1e-5, atol=1e-6)):
        raise AssertionError(f"VectorIndex.search at D {BASE_D} differs from the numpy oracle")
    if not np.allclose(vindex.score_all(queries[:2]), np.sqrt(np.maximum(d2[:2].T, 0.0)),
                       rtol=1e-5, atol=1e-6):
        raise AssertionError(f"VectorIndex.score_all at D {BASE_D} differs from the numpy oracle")
    timings = {f"search(k=10) Q {qn}": cuda_ms(lambda qn=qn: vindex.search(queries[:qn], k=10),
                                               1, 5) for qn in (1, 8)}
    timings["score_all Q 2"] = cuda_ms(lambda: vindex.score_all(queries[:2]), 1, 5)
    peak = torch.cuda.max_memory_allocated(device) - base
    log(f"    VectorIndex {INDEX_TILES} x {BASE_D} ({embeds.nbytes / 1e9:.3f} GB): search(k=10) "
        f"== the f64 oracle's top-10, top-1 == planted, score_all == the oracle; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in timings.items())
        + f" (CUDA events, median of 5); peak device memory {peak / 1e9:.3f} GB above the "
        f"baseline ({card})")
    del vindex, embeds
    torch.cuda.empty_cache()
    check_no_kernel("the baseline VectorIndex")

    # the daemon
    rng = np.random.default_rng(55)
    photos = [png_bytes(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
              for _ in range(BASE_REQUESTS)]
    for precision, int8 in (("bf16", False), ("int8", True)):
        index = indexes[precision]
        service = serve_tool.GeolocateService(index, cfg, params, int8=int8, max_batch=8,
                                              family="baseline")
        seen_embeds = []
        real_embed = service._embed

        def recording_embed(imgs, real_embed=real_embed, seen=seen_embeds):
            out = real_embed(imgs)
            seen.append((imgs, out))
            return out

        service._embed = recording_embed
        server = serve_tool.serve(service, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            service.warmup()
            seen_embeds.clear()
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                answers = list(pool.map(lambda p: http_json(f"{url}/geolocate?k=5", p), photos))
            wall = time.perf_counter() - t0
            stats, _ = http_json(f"{url}/stats")
            health, _ = http_json(f"{url}/healthz")
            check_no_kernel(f"the baseline daemon ({precision})")
            direct = []
            for imgs, embs in seen_embeds:
                i_d, d_d = index.search(embs, k=service._k_bucket(5))
                direct += [(imgs[r], i_d[r, :5], d_d[r, :5]) for r in range(len(imgs))]
                with torch.no_grad():
                    x = service._tower_input(torch.from_numpy(imgs).to(device))
                    want = (quantize.quantized_baseline_forward_static(service._sq, x) if int8
                            else service._tower(x))
                check_vectors(embs, want, int8, f"the {precision} baseline daemon's embeddings")
            for photo, (out, _) in zip(photos, answers):
                img = service._decode(photo)
                _, i_d, d_d = next(t for t in direct if np.array_equal(t[0], img))
                res = out["results"]
                if ([r["tile"] for r in res] != i_d.tolist()
                        or [r["distance"] for r in res] != [float(v) for v in d_d]
                        or any(r["orientation_deg"] is not None for r in res)
                        or [r["score"] for r in res] != [float(np.exp(-v)) for v in d_d]):
                    raise AssertionError(f"{precision} baseline daemon answer differs from the "
                                         f"direct search")
            if (stats["requests"] != BASE_REQUESTS or stats["errors"] != 0
                    or health["family"] != "baseline" or health["int8"] != int8
                    or img.shape != (500, 500, 3)):
                raise AssertionError(f"{precision} baseline daemon: stats {stats}, health {health}")
            p50, p99 = (1e3 * float(np.percentile([t for _, t in answers], q)) for q in (50, 99))
            log(f"    daemon {precision}: {BASE_REQUESTS} requests in {wall:.3f} s = "
                f"{BASE_REQUESTS / wall:.2f} requests/s, latency p50 {p50:.2f} ms, p99 "
                f"{p99:.2f} ms (host clock, 8 clients) ({card}); mean batch "
                f"{stats['mean_batch']}; every answer == VectorIndex.search on the daemon's "
                f"embeddings, score exp(-d), orientation null; the embeddings == the tower's")
        finally:
            server.shutdown()
            server.server_close()
            service.close()

    # the heatmap sweep
    t0 = time.perf_counter()
    bounds, side = write_strip(BASE_DIR, BASE_SWEEP_SIDE)
    photo_paths = []
    for k in range(2):
        photo_paths.append(str(BASE_DIR / f"photo{k}.png"))
        (BASE_DIR / f"photo{k}.png").write_bytes(
            png_bytes(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)))
    log(f"    wrote a {side} x {side} x 3 strip for a {BASE_SWEEP_SIDE} x {BASE_SWEEP_SIDE} grid "
        f"in {time.perf_counter() - t0:.2f} s")
    _, _, windows = heatmap.window_grid(bounds, 225.0, 56.25)
    with geotiff.GeoTiff(str(BASE_DIR / "03_paris.tif")) as sat:
        first_tiles = np.stack([geotiff.resample(sat.read_world_window(*w).astype(np.float32),
                                                 750, 750) for w in windows[:8]])
    cache = BASE_DIR / "tiles.npz"
    n = BASE_SWEEP_SIDE ** 2
    real_score = VectorIndex.score_all

    def record_score(index, query_embeds, *args, **kwargs):
        seen["s_emb"] = np.array(query_embeds)
        return real_score(index, query_embeds, *args, **kwargs)

    quantize.calibrate_overhead_span = record_span
    VectorIndex.score_all = record_score
    try:
        for precision, flags in (("bf16", []), ("int8", ["--int8"])):
            argv = (["-a", "3", "-b", *map(str, bounds), "-s", str(BASE_DIR), "-p", *photo_paths,
                     "--weights", str(weights), "--family", "baseline", "--index-cache",
                     str(cache)] + flags)
            runs = {}
            for run in ("cold", "warm"):
                torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                heatmap.main(argv + ["-c", str(BASE_DIR / f"{precision}_{run}.csv")])
                torch.cuda.synchronize()
                runs[run] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated(device))
                check_no_kernel(f"the {run} baseline sweep ({precision})")
            header, cold = read_sweep_csv(BASE_DIR / f"{precision}_cold.csv")
            _, warm = read_sweep_csv(BASE_DIR / f"{precision}_warm.csv")
            if header != ["photo", "x", "y", "dissimilarity", "score"] or len(cold) != 2 * n \
                    or warm != cold:
                raise AssertionError(f"baseline {precision} CSV: header {header}, {len(cold)} rows")
            d_col = np.asarray([r[3] for r in cold], np.float64)
            score = np.asarray([r[4] for r in cold], np.float64)
            if not (np.isfinite(d_col).all() and np.allclose(score, np.exp(-d_col), rtol=1e-6,
                                                             atol=0)):
                raise AssertionError(f"baseline {precision}: scores are not exp(-d)")
            index = VectorIndex.load(str(cache), device)
            if (len(index) != n or str(index.meta["family"]) != "baseline"
                    or str(index.meta["precision"]) != ("int8" if flags else "f32")):
                raise AssertionError(f"baseline {precision} cache: {len(index)} tiles, meta "
                                     f"{ {k: str(v)[:40] for k, v in index.meta.items()} }")
            x = torch.from_numpy(first_tiles).to(device)
            with torch.no_grad():
                want = (quantize.quantized_baseline_forward_static(seen["sq"], x) if flags
                        else functional_call(model, params["overhead"], (x,), strict=True))
            check_vectors(index.embeds[:8], want, bool(flags), f"baseline {precision} sweep cache")
            dd = float(np.abs(real_score(index, seen["s_emb"][:1])[:, 0] - d_col[:n]).max())
            if not dd <= 1e-5:
                raise AssertionError(f"baseline {precision}: photo 0's rows differ from score_all "
                                     f"({dd})")
            log(f"    heatmap --family baseline {precision}: {n} tiles of 750^2 cold "
                f"{runs['cold'][0]:.3f} s = {n / runs['cold'][0]:.2f} tiles/s (arguments to CSV, "
                f"host clock), peak device memory {runs['cold'][1] / 1e9:.3f} GB; warm (cache hit) "
                f"{runs['warm'][0]:.3f} s ({card}); {len(cold)} rows == warm rows, score == "
                f"exp(-d), the cache's first 8 vectors == the tower's, photo 0's rows == "
                f"VectorIndex.score_all (max |dd| {dd:.3e})")
    finally:
        quantize.calibrate_overhead_span = real_span
        VectorIndex.score_all = real_score

    # cli.cvig_baseline
    t0 = time.perf_counter()
    csv_cli = write_baseline_cli_dataset(BASE_DIR / "cli", BASE_CLI_PAIRS)
    log(f"    wrote {BASE_CLI_PAIRS} WITW-schema pairs in {time.perf_counter() - t0:.2f} s")
    flags = ["--dataset", "witw", "--train-csv", csv_cli, "--test-csv", csv_cli]
    real_run_train = cli_common.run_train

    def run_train_small_val(cfg, tag, num_epochs=None, profile_dir=None, device=None):
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, val_quantity=BASE_CLI_VAL))
        return real_run_train(cfg, tag, num_epochs=num_epochs, profile_dir=profile_dir,
                              device=device)

    results = {}
    cwd = os.getcwd()
    os.chdir(BASE_DIR)
    cli_common.run_train = run_train_small_val
    try:
        for run, argv in (("train", ["--mode", "train", "--epochs", "1"]),
                          ("test", ["--mode", "test"])):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                results[run] = cvig_baseline.main(argv + flags)
            check_no_kernel(f"cvig_baseline {run}")
            log(f"    cvig_baseline {run}: {time.perf_counter() - t0:.2f} s (host clock, arguments "
                f"to return)")
        ckpt = BASE_DIR / "weights" / "baseline_witw"
        cli_cfg = cli_common.apply_overrides(baseline_experiment("witw"),
                                             cli_common.base_parser(False).parse_args(flags))
        cli_batch = cli_cfg.train.batch_size
        if not ((ckpt / "best.pt").exists() and (ckpt / "latest.pt").exists()):
            raise AssertionError(f"no best.pt / latest.pt in {ckpt}")
        records = [json.loads(line) for line in
                   (BASE_DIR / "runs" / "baseline_witw" / "train" / "metrics.jsonl").read_text()
                   .splitlines()]
        tags = {r["tag"] for r in records}
        losses = [r["value"] for r in records if r["tag"] in ("train loss", "val loss")]
        steps = ((BASE_CLI_PAIRS - BASE_CLI_VAL) // cli_batch + -(-BASE_CLI_VAL // cli_batch))
        if (not {"train loss", "val loss", "train pairs_per_sec", "best_loss"} <= tags
                or "val_embedding" in tags or len(losses) != steps
                or not np.isfinite(losses).all()):
            raise AssertionError(f"cvig_baseline train metrics.jsonl: tags {tags}, losses {losses}")
        cli_rate = next(r["value"] for r in records if r["tag"] == "train pairs_per_sec")
        cli_pipeline = BaselinePipeline(cli_cfg, device)
        restored = Checkpointer(str(ckpt)).restore(
            "best", cli_pipeline.init_state(torch.Generator().manual_seed(0))).params
        test_loader = cli_common.build_loader(
            cli_cfg, read_pair_paths(cli_cfg.data.dataset, csv_cli), shuffle=False,
            drop_last=False, batch_size=cli_cfg.eval.batch_size)
        try:
            direct = loop.test(cli_cfg, cli_pipeline, test_loader, restored, verbose=False)
        finally:
            test_loader.close()
        if direct != results["test"] or direct["locations"] != BASE_CLI_PAIRS:
            raise AssertionError(f"cvig_baseline test {results['test']} != loop.test {direct}")
        check_no_kernel("the baseline CLI check")
        log(f"    cvig_baseline: losses finite {[round(v, 5) for v in losses]}; best.pt, latest.pt; "
            f"no embedding dump; test {json.dumps(results['test'])} == loop.test on the restored "
            f"best (euclidean_ranks, rotation seeded seed + 1); train {cli_rate:.2f} pairs/s "
            f"(the loop's StepTimer, host clock, batch {cli_batch}) ({card})")
    finally:
        cli_common.run_train = real_run_train
        os.chdir(cwd)
        shutil.rmtree(BASE_DIR, ignore_errors=True)


REMAINDER_DIR = Path(__file__).resolve().parent / ".smoke_remainder"
DYN_BATCH = 128
KERNEL_A = "conv3x3_int8_kernel"  # kernel A's __global__ function (its SASS and profiler name)


def reference_layout(state, layout):
    """A FovDsm state dict in a ``.pth`` layout: the reference's wrapped
    ``model.features.N.layer.*`` or torchvision's ``features.N.*`` (extended
    with the head convs at their feature indices 23 / 25 / 27)."""
    out = {}
    for k, v in state.items():
        name, field = k.rsplit(".", 1)
        idx = name.split("_")[-1]
        key = f"model.features.{idx}.layer" if layout == "reference" else f"features.{idx}"
        out[f"{key}.{field}"] = v.detach().cpu().clone()
    return out


def dynamic_distance(pipeline, q_s, q_o, batch):
    """The dynamic-int8 serving forward: f32 preprocess, both dynamic-int8
    towers, the fused match -> d [Bo, Bs]."""
    surface, polar = pipeline.preprocess(batch)
    s_emb = quantize.quantized_fov_forward(q_s, surface, False)
    o_emb = quantize.quantized_fov_forward(q_o, polar, True)
    return fused_match.fused_chord_distance_nhwc(o_emb, s_emb)[0]


def device_split_us(run, steps, classify):
    """torch.profiler over ``steps`` calls of ``run``: device microseconds by
    ``classify(kernel name, the name of the kernel before it)``, the device
    events' total, and the microseconds of each kernel name. By names and
    order alone: kernels launched through ctypes have no PyTorch op to
    attribute them to."""
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    split = collections.defaultdict(float)
    by_kernel = collections.defaultdict(float)
    prev = ""
    for e in kernels:
        us = e.time_range.elapsed_us()
        split[classify(e.name, prev)] += us
        by_kernel[e.name] += us
        prev = e.name
    return dict(split), sum(split.values()), dict(by_kernel)


def phase_remainder(card, device):
    """[29] the single-device remainder at fov_experiment("cvusa", 360): the
    .pth converter, the config YAML, the dynamic-int8 towers on kernel A's
    dequant epilogue, async checkpoint saves. Returns (the dynamic path's
    launches {module: n}, its pairs/s, the converted towers' conv3x3
    launches)."""
    cfg = fov_experiment("cvusa", 360)
    d = cfg.data
    log(f"[29] single-device remainder, fov_experiment('cvusa', 360): {d.surface_height} x "
        f"{d.surface_width_max} surface and polar map, random weights from a seed; (a) the .pth "
        f"converter, (b) the config YAML, (c) the dynamic-int8 towers at batch {DYN_BATCH}, every "
        f"conv on kernel A's dequant epilogue with x_scale * w_scale from the device, (d) async "
        f"checkpoint saves")
    shutil.rmtree(REMAINDER_DIR, ignore_errors=True)
    REMAINDER_DIR.mkdir()
    pipeline = FovPipeline(cfg, device)
    params = pipeline.init(torch.Generator().manual_seed(29))
    batch = raw_batch(np.random.default_rng(29), cfg, DYN_BATCH)

    # (a) the converter: both layouts through .pth files and the CLI's npz
    reset_kernel_counts()
    want_s, want_o = pipeline.embed_step(params, batch)
    torch.cuda.synchronize()
    from_source = conv3x3.launches
    convert_launches = 0
    for layout in ("reference", "torchvision"):
        loaded = {}
        for tower in ("surface", "overhead"):
            src = REMAINDER_DIR / f"{layout}_{tower}.pth"
            torch.save(reference_layout(params[tower], layout), src)
            sd = convert_torch.convert_fov_dsm_state_dict(convert_torch.load_torch_file(str(src)))
            npz = REMAINDER_DIR / f"{layout}_{tower}.npz"
            convert_torch.main([str(src), str(npz)])
            via_npz = convert_torch.load_converted(str(npz))
            if sorted(sd) != sorted(params[tower]) or sorted(via_npz) != sorted(sd):
                raise AssertionError(f"{layout} {tower}: converted names differ from the tower's")
            for k, v in sd.items():
                if not (torch.equal(v, params[tower][k].cpu()) and torch.equal(via_npz[k], v)):
                    raise AssertionError(f"{layout} {tower}: {k} changed in the conversion")
            loaded[tower] = {k: v.to(device) for k, v in sd.items()}
        before = conv3x3.launches
        got_s, got_o = pipeline.embed_step(loaded, batch)
        torch.cuda.synchronize()
        convert_launches += conv3x3.launches - before
        if conv3x3.launches == before:
            raise AssertionError("the converted towers did not launch conv3x3_bf16")
        if not (torch.equal(got_s, want_s) and torch.equal(got_o, want_o)):
            raise AssertionError(f"{layout}: the converted towers' embeddings differ: max |d| "
                                 f"{float((got_s - want_s).abs().max()):.3e}, "
                                 f"{float((got_o - want_o).abs().max()):.3e}")
        log(f"    (a) {layout} layout (e.g. {next(iter(reference_layout(params['surface'], layout)))}"
            f"): .pth -> convert_fov_dsm_state_dict and -> the CLI's npz -> load_converted: every "
            f"array equal; bf16 towers (conv3x3_bf16, {conv3x3.launches - before} launches) on "
            f"them == the source towers' embeddings {tuple(got_s.shape)}, {tuple(got_o.shape)}, "
            f"bit for bit")
    del loaded, got_s, got_o, want_s, want_o
    if from_source < 1:
        raise AssertionError("the source towers did not launch conv3x3_bf16")

    # (b) the config YAML, the port's own writer and reader
    for name, make in (("fov", lambda: fov_experiment("cvusa", 360)),
                       ("semantic", lambda: semantic_experiment("witw", 90)),
                       ("safa", lambda: safa_experiment("witw", 70)),
                       ("baseline", lambda: baseline_experiment("witw"))):
        path = REMAINDER_DIR / f"{name}.yaml"
        serialize.save_config(make(), str(path))
        if serialize.load_config(str(path)) != make():
            raise AssertionError(f"{name}: the YAML round trip changed the config")
    log(f"    (b) save_config / load_config: the fov, semantic, safa and baseline presets round "
        f"trip equal ({path.stat().st_size} bytes for baseline; "
        f"{'PyYAML is' if importlib.util.find_spec('yaml') else 'PyYAML is not'} installed here "
        f"and not imported)")

    # (c) the dynamic-int8 towers
    t0 = time.perf_counter()
    q_s, q_o = quantize.quantize_pipeline(params)
    torch.cuda.synchronize()
    log(f"    (c) quantize_pipeline (both towers, kernel A's tables packed): "
        f"{time.perf_counter() - t0:.2f} s")
    # the main path, each conv's kernel A output held against its plain
    # version on the same int8 inputs and device-computed dequant vector
    per_layer = []
    real = quantize.conv3x3_int8_dequant

    def checked(x, w, dequant, bias_f, stride_h=1, pad_w=1, w_wgmma=None):
        y = real(x, w, dequant, bias_f, stride_h, pad_w, w_wgmma)
        want = int8_conv.conv3x3_int8_dequant_plain(x, w, dequant, bias_f, stride_h, pad_w)
        per_layer.append((tuple(x.shape), w.shape[0], stride_h, pad_w,
                          float((y - want).abs().max()), torch.equal(y, want)))
        return y

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    reset_kernel_counts()
    quantize.conv3x3_int8_dequant = checked
    try:
        with torch.no_grad():
            dist = dynamic_distance(pipeline, q_s, q_o, batch)
        torch.cuda.synchronize()
    finally:
        quantize.conv3x3_int8_dequant = real
    t_checked = time.perf_counter() - t0
    launches = kernel_counts()
    if (launches["int8_conv"] != 2 * len(quantize.CONV_ORDER) or launches["fused_match"] != 1
            or any(launches[n] for n in launches if n not in ("int8_conv", "fused_match"))):
        raise AssertionError(f"the dynamic path launched {launches}: expected kernel A once per "
                             f"conv ({2 * len(quantize.CONV_ORDER)}) and the fused match once")
    if dist.shape != (DYN_BATCH, DYN_BATCH) or not bool(torch.isfinite(dist).all()):
        raise AssertionError(f"dynamic distances: {tuple(dist.shape)}, finite "
                             f"{bool(torch.isfinite(dist).all())}")
    dynamic = {n: c for n, c in launches.items() if c}
    log(f"    dynamic int8 embed+match batch {DYN_BATCH}: d {tuple(dist.shape)} mean "
        f"{float(dist.mean()):.6f}; launches {dynamic} (kernel A: {len(quantize.CONV_ORDER)} "
        f"convs per tower, the stride-2 head convs included)")
    for (shape, co, sh, pw, err, equal), name in zip(per_layer, 2 * quantize.CONV_ORDER):
        log(f"      {name} x {shape} Co={co} stride_h={sh} pad_w={pw}: max |kernel - plain| "
            f"{err:.3e}{'' if equal else ' (NOT bit-equal)'}")
    if len(per_layer) != 2 * len(quantize.CONV_ORDER) or not all(e for *_, e in per_layer):
        raise AssertionError("kernel A's dequant epilogue differs from its plain version")
    log(f"    all {len(per_layer)} convs of both towers in that run (batch {DYN_BATCH}) bit-equal "
        f"to conv3x3_int8_dequant_plain on the same int8 inputs and device-computed dequant "
        f"vectors; the run with its checks {t_checked:.2f} s (host clock), peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB ({card})")

    # cosine per embedding against the f32 towers (cuDNN, TF32 off) on the same inputs
    cfg32 = fov_experiment("cvusa", 360, model=dataclasses.replace(cfg.model,
                                                                   compute_dtype="float32"))
    pipe32 = FovPipeline(cfg32, device)
    with torch.no_grad():
        surface, polar = pipeline.preprocess(batch)
        ref_s, ref_o = pipe32._towers(params, surface, polar, False, None)
        dyn_s = quantize.quantized_fov_forward(q_s, surface, False)
        dyn_o = quantize.quantized_fov_forward(q_o, polar, True)
    for tower, got, ref in (("surface", dyn_s, ref_s), ("overhead", dyn_o, ref_o)):
        a, b = got.reshape(DYN_BATCH, -1), ref.reshape(DYN_BATCH, -1)
        cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))
        log(f"    {tower} tower {tuple(got.shape)}: cosine against the f32 tower per embedding "
            f"min {float(cos.min()):.6f}, median {float(cos.median()):.6f} (> 0.99, witw_tpu's bar)")
        if not bool((cos > 0.99).all()):
            raise AssertionError(f"{tower}: {int((cos <= 0.99).sum())} embeddings at cosine <= 0.99")
    del ref_s, ref_o, dyn_s, dyn_o, pipe32

    # timing (CUDA events, median of 5 runs of 4 steps) and the device split
    gen_in = torch.Generator(device=device).manual_seed(29)
    staged = [{"surface": torch.rand(DYN_BATCH, d.surface_height, d.surface_width_max, 3,
                                     generator=gen_in, device=device) * 255.0,
               "overhead": torch.rand(DYN_BATCH, d.overhead_size, d.overhead_size, 3,
                                      generator=gen_in, device=device) * 255.0}
              for _ in range(2)]
    step_of = iter(range(10 ** 9))

    def stage(fn):
        return lambda: fn(staged[next(step_of) % len(staged)])

    with torch.no_grad():
        t_dyn = cuda_ms(stage(lambda b: dynamic_distance(pipeline, q_s, q_o, b)), 4, 5)
        t_bf16 = cuda_ms(stage(lambda b: pipeline.forward_distance(params, b)), 4, 5)
        t_pre = cuda_ms(stage(pipeline.preprocess), 4, 5)
        surface, polar = pipeline.preprocess(staged[0])
        t_surface = cuda_ms(lambda: quantize.quantized_fov_forward(q_s, surface, False), 4, 5)
        t_towers = cuda_ms(lambda: (quantize.quantized_fov_forward(q_s, surface, False),
                                    quantize.quantized_fov_forward(q_o, polar, True)), 4, 5)
    pairs_per_s = DYN_BATCH * 1000.0 / t_dyn
    log(f"    embed+match batch {DYN_BATCH} (fov 360, varied inputs, CUDA events, median of 5 runs "
        f"of 4): dynamic int8 {t_dyn:.3f} ms/step = {pairs_per_s:.2f} pairs/s; bf16 {t_bf16:.3f} "
        f"ms/step = {DYN_BATCH * 1000.0 / t_bf16:.2f} pairs/s; preprocess {t_pre:.3f} ms; the "
        f"dynamic surface tower alone {t_surface:.3f} ms, both towers {t_towers:.3f} ms ({card})")

    def classify(kernel, prev):
        """A kernel's stage, by the names CUDA PyTorch gives its kernels; a
        clamp right after kernel A is the ReLU of its output (torch.relu and
        the quantizer's clip both run PyTorch's clamp kernel)."""
        if KERNEL_A in kernel:
            return "kernel A"
        if "max_pool" in kernel:
            return "2x2 pools (f32)"
        if "clamp" in kernel and KERNEL_A in prev:
            return "ReLU passes"
        if "CatArrayBatchedCopy" in kernel:
            return "wrap-pad copies"
        return "abs-max and quantize passes (abs, amax, divide, round, clip, cast, scales)"

    with torch.no_grad():
        split, device_us, by_kernel = device_split_us(lambda: (
            quantize.quantized_fov_forward(q_s, surface, False),
            quantize.quantized_fov_forward(q_o, polar, True)), PROFILE_STEPS, classify)
    if device_us <= 0 or split.get("kernel A", 0.0) <= 0:
        raise AssertionError(f"torch.profiler saw no device time or no kernel A: {split}")
    total = device_us / PROFILE_STEPS / 1e3
    log(f"    device profile (torch.profiler, {PROFILE_STEPS} steps) of both dynamic towers on "
        f"preprocessed inputs: {total:.3f} ms of kernels per step, {100 * total / t_towers:.1f}% "
        f"of the towers' {t_towers:.3f} ms (CUDA events) ({card}); "
        + "; ".join(f"{k} {v / PROFILE_STEPS / 1e3:.3f} ms ({100 * v / device_us:.1f}%)"
                    for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    log("    top kernels (ms per step): " + "; ".join(
        f"{k[:90]} {v / PROFILE_STEPS / 1e3:.3f}"
        for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]))
    del staged, surface, polar, q_s, q_o

    # (d) async checkpoint saves of the full-width train state
    state = pipeline.init_state(torch.Generator().manual_seed(30))
    ck = Checkpointer(str(REMAINDER_DIR / "async"), keep=2, async_saves=True)
    returns = []
    try:
        for step in (1, 2, 3):
            with torch.no_grad():
                for p in state.params.values():
                    for v in p.values():
                        v.add_(1.0)
            state.step = step
            t0 = time.perf_counter()
            ck.save_step(state, step, {"epoch": 0})
            returns.append(time.perf_counter() - t0)
        want = {t: {k: v.detach().cpu().clone() for k, v in p.items()}
                for t, p in state.params.items()}
        t0 = time.perf_counter()
        fresh = pipeline.init_state(torch.Generator().manual_seed(31))
        ck.restore_latest(fresh)
        t_restore = time.perf_counter() - t0
    finally:
        ck.close()
    if fresh.step != 3 or any(not torch.equal(fresh.params[t][k].cpu(), v)
                              for t, p in want.items() for k, v in p.items()):
        raise AssertionError("restore_latest after async saves did not give the last saved state")
    kept = sorted(f.name for f in (REMAINDER_DIR / "async").glob("step_*.pt"))
    if kept != ["step_2.pt", "step_3.pt"]:
        raise AssertionError(f"keep=2 left {kept}")
    size = (REMAINDER_DIR / "async" / "latest.pt").stat().st_size
    log(f"    (d) Checkpointer(async_saves=True, keep=2), 3 save_steps of the full-width state "
        f"({size / 1e6:.1f} MB a file): save_step returned in "
        f"{', '.join(f'{t:.3f}' for t in returns)} s (the host copy; the writes on the writer "
        f"thread), restore_latest (waits for them) {t_restore:.3f} s: step 3, params equal; "
        f"{kept} kept (host clock)")
    shutil.rmtree(REMAINDER_DIR)
    return dynamic, pairs_per_s, convert_launches


# --- gallery and query sharding over a device mesh (30) ----------------------

SHARD_PAIRS = 1001  # 7 batches of 128 and a straggler of 105, which a mesh of 2 does not divide
SHARD_REQUESTS = 16


def planted_batches(cfg, n, batch, seed, device, noise=0.1):
    """n planted pairs on the card in batches of ``batch``, the last one
    short: blocky overhead tiles (4 x 4 blocks) and surfaces that are their
    own tile's polar panorama under noise growing to ``noise`` x 128
    (tests/test_torch_slice.py's pairs at full width). With tied towers each
    query's true match stands apart, so ranks do not sit on the bf16
    rounding that another batch size moves (ROADMAP's ground rule: ranks
    only on planted data)."""
    d = cfg.data
    gen = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand(n, 4, 4, 3, generator=gen, device=device) * 255.0
    block = d.overhead_size // 4
    over = coarse.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)
    pol = polar_transform(over, d.surface_height, d.surface_width_max)
    scale = torch.linspace(0.0, noise, n, device=device)[:, None, None, None] * 128.0
    surf = (pol + scale * torch.randn(pol.shape, generator=gen, device=device)).clamp(0, 255)
    return [{"surface": surf[a:a + batch], "overhead": over[a:a + batch]}
            for a in range(0, n, batch)]


def timed(fn):
    """(fn's result, host seconds around it, ended by a synchronize)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sharded(card, device, indexes, serve_params):
    """[30] Gallery and query sharding over a mesh that names the card twice:
    loop.test at full width, the planted 8832-pair sweeps, euclidean_ranks,
    GalleryIndex / VectorIndex at 100,000 items, the daemon in bf16 and
    --int8 and [21]'s strip swept warm, each against its single-device call
    in this run. Every check runs and is logged; the phase raises at the end
    if any failed. Returns the kernels' launches on the sharded paths."""
    mesh = make_mesh(devices=[device, device])
    log(f"[30] sharding over make_mesh(devices=[{device}, {device}]): {mesh} (one card named "
        f"twice: two shards on it; placement, the merge and equal results, no speed-up "
        f"claimed; times are host clock, ended by a synchronize) ({card})")
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            log(f"    FAILED: {what}")

    counted = dict(INT8_MODULES, conv3x3=conv3x3, fused_match=fused_match)
    launches = {n: 0 for n in counted}

    def count(fn):
        """fn()'s result and the launches it made, added to the phase's."""
        for mod in counted.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        made = {n: mod.launches for n, mod in counted.items()}
        for n, c in made.items():
            launches[n] += c
        return out, made

    # (a) loop.test at full width, batch 128: planted pairs with a straggler,
    # then random pairs in whole batches
    cfg = fov_experiment("cvusa", 360)
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, batch_size=128))
    pipeline = FovPipeline(cfg, device)
    tower = pipeline.init(torch.Generator().manual_seed(0))["overhead"]
    tied = {"surface": tower, "overhead": tower}  # as the planted pairs need
    seed = lambda: torch.Generator().manual_seed(cfg.train.seed + 1)  # noqa: E731
    d = cfg.data
    gen = torch.Generator(device=device).manual_seed(31)
    randoms = [{"surface": torch.randint(0, 256, (128, d.surface_height, d.surface_width_max, 3),
                                         generator=gen, device=device, dtype=torch.uint8),
                "overhead": torch.randint(0, 256, (128, d.overhead_size, d.overhead_size, 3),
                                          generator=gen, device=device, dtype=torch.uint8)}
               for _ in range(8)]
    for name, batches, params in (
            (f"{SHARD_PAIRS} planted pairs (towers tied) in batches of 128, the last 105 padded "
             f"to 106 over the data axis", planted_batches(cfg, SHARD_PAIRS, 128, 30, device), tied),
            ("1024 random pairs in 8 batches of 128", randoms,
             pipeline.init(torch.Generator().manual_seed(1)))):
        n = sum(len(b["surface"]) for b in batches)
        (_, ranks_one), t_one = timed(lambda: loop.test_ranks(cfg, pipeline, batches, params,
                                                              verbose=False))
        s_one, o_one = loop.embed_all(pipeline, params, batches, seed())
        emb, made = count(lambda: loop.embed_all(pipeline, params, batches, seed(), mesh=mesh))
        check(made["conv3x3"] > 0, f"embed_all(mesh=) launched no conv3x3_bf16: {made}")
        check(emb[0].shape == s_one.shape and emb[1].shape == o_one.shape,
              f"embed_all(mesh=) shapes {emb[0].shape}, {emb[1].shape}")
        size = len(batches[0]["surface"])
        full = size * (n // size)
        d_full = max(float((a[:full] - b[:full]).abs().max()) for a, b in zip(emb, (s_one, o_one)))
        note = ""
        if n > full:
            d_last = max(float((a[full:] - b[full:]).abs().max()) for a, b in zip(emb, (s_one, o_one)))  # one device alone: the straggler's first 53 pairs at 53 beside 105
            last, rows = batches[-1], (n - full + 1) // 2
            alone = pipeline.embed_step(params, {k: v[:rows] for k, v in last.items()})
            whole = pipeline.embed_step(params, last)
            moved = sum((a[:rows] - b).flatten(1).abs().amax(1) > 0 for a, b in zip(whole, alone))
            note = (f", the straggler's {d_last:.3e}; one device alone, the straggler's first "
                    f"{rows} pairs embedded at batch {rows} beside {n - full}: max |d emb| "
                    f"{max(float((a[:rows] - b).abs().max()) for a, b in zip(whole, alone)):.3e},"
                    f" {int((moved > 0).sum())} of {rows} rows moved")
        log(f"    fov_experiment('cvusa', 360), random weights from a seed, {name}: "
            f"embed_all(mesh=) vs one device max |d emb| over the whole batches' rows "
            f"{d_full:.3e}{note}; conv3x3_bf16 launches {made['conv3x3']}; one device's ranks "
            f"{len(np.unique(ranks_one))} distinct, mean {ranks_one.mean():.4f}")
        for shard_gallery in (False, True):
            c = cfg.replace(eval=dataclasses.replace(cfg.eval, shard_gallery=shard_gallery))
            ((_, ranks), dt), made = count(lambda c=c: timed(lambda: loop.test_ranks(
                c, pipeline, batches, params, verbose=False, mesh=mesh)))
            what = "gallery-resident" if shard_gallery else "query-axis"
            check(made["fused_match"] > 0 and made["conv3x3"] > 0,
                  f"loop.test(mesh=) {what}: launches {made}")
            check(np.array_equal(ranks, ranks_one), f"loop.test(mesh=) {what} ranks differ from "
                  f"one device's on {int((ranks != ranks_one).sum())} of {n} queries")
            log(f"    loop.test(mesh=), {what} sweep through the fused match: {dt:.3f} s (one "
                f"device {t_one:.3f} s) ({card}); ranks == one device's "
                f"{np.array_equal(ranks, ranks_one)}; launches fused match "
                f"{made['fused_match']}, conv3x3_bf16 {made['conv3x3']}")
        del batches, params, emb, s_one, o_one
    del pipeline, tied, randoms

    # (b) the 8832-pair planted sweep of [6], fused and FFT, both shardings
    o_pl, s_pl = (torch.from_numpy(x).to(device) for x in
                  planted_embeddings(np.random.default_rng(4), 8832, 4, 64, 16, 64))
    one = {fused: timed(lambda fused=fused: FovGalleryEvaluator(
        use_fused=fused, device=device).ranks(o_pl, s_pl)) for fused in (True, False)}
    for shard_gallery in (False, True):
        for fused in (True, False):
            ev = FovGalleryEvaluator(use_fused=fused, mesh=mesh, shard_gallery=shard_gallery)
            (ranks, dt), made = count(lambda ev=ev: timed(lambda: ev.ranks(o_pl, s_pl)))
            what = (f"{'gallery-resident' if shard_gallery else 'query-axis'} "
                    f"{'fused' if fused else 'FFT'}")
            check((made["fused_match"] > 0) == fused, f"8832 {what}: launches {made}")
            check(np.array_equal(ranks, one[fused][0]),
                  f"8832 {what}: ranks differ on {int((ranks != one[fused][0]).sum())} queries")
            where = ""
            if shard_gallery:
                where = "; shards " + ", ".join(
                    f"{p['device']} rows {p['start']}..{p['start'] + p['valid'] - 1} "
                    f"(+{p['rows'] - p['valid']} padded)" for p in ev.last_gallery_placement)
            log(f"    8832 planted pairs [8832, 4, 64, 16], {what}: {dt:.4f} s (one device "
                f"{one[fused][1]:.4f} s) ({card}); ranks == one device's "
                f"{np.array_equal(ranks, one[fused][0])}; fused match launches "
                f"{made['fused_match']}{where}")
    del o_pl, s_pl

    # (c) euclidean_ranks over 8832^2 at the SAFA and baseline widths
    gen = torch.Generator(device=device).manual_seed(35)
    for dim in (RANK_D, BASE_D):
        g = lattice(gen, (RANK_PAIRS, dim), device)
        q = planted_queries(gen, g, torch.arange(RANK_PAIRS, device=device),
                            torch.linspace(0.0, 1.0, RANK_PAIRS, device=device))
        want, t_w = timed(lambda: gallery.euclidean_ranks(g, q))
        got, t_g = timed(lambda: gallery.euclidean_ranks(g, q, mesh=mesh))
        check(np.array_equal(got, want), f"euclidean_ranks(mesh=) at D {dim} differs on "
              f"{int((got != want).sum())} queries")
        log(f"    euclidean_ranks(mesh=), {RANK_PAIRS} planted integer-lattice pairs at D = "
            f"{dim}: == one device's {np.array_equal(got, want)} ({len(np.unique(got))} "
            f"distinct ranks); {t_g:.4f} s, one device {t_w:.4f} s ({card})")
    del g, q

    # (d) GalleryIndex at 100,000 tiles
    rng = np.random.default_rng(36)
    gen = torch.Generator(device=device).manual_seed(36)
    embeds = torch.randn(INDEX_TILES, 4, 64, 16, generator=gen, device=device).cpu().numpy()
    planted = rng.choice(INDEX_TILES, 8, replace=False)
    starts = rng.integers(0, 64, 8)
    index = GalleryIndex(embeds, device=device)
    _, t_place = timed(lambda: index.place_sharded(mesh))
    shards = ", ".join(f"{p['device']} rows {p['start']}..{p['start'] + p['valid'] - 1} "
                       f"(+{p['rows'] - p['valid']} padded)" for p in index.last_gallery_placement)
    log(f"    GalleryIndex {INDEX_TILES} x [4, 64, 16]: place_sharded {t_place:.3f} s; {shards}; "
        f"chunk {index._sharded['chunk']}, max_k {index._sharded['max_k']}")
    for sw in (64, 12):
        cols = (starts[:, None] + np.arange(sw)[None]) % 64
        q = np.stack([embeds[t][:, c] for t, c in zip(planted, cols)])
        q = (q + 0.1 * rng.standard_normal(q.shape, dtype=np.float32)).astype(np.float32)
        index.search(q, k=10)  # the first calls build each path's tables
        index.search_sharded(q, k=10)
        (i1, d1, o1), t1 = timed(lambda: index.search(q, k=10))
        (i2, d2, o2), t2 = timed(lambda: index.search_sharded(q, k=10))
        (s1, so1), t3 = timed(lambda: index.score_all(q))
        (s2, so2), t4 = timed(lambda: index.score_all_sharded(q))
        top = np.zeros(s1.shape, bool)
        np.put_along_axis(top, i1.T, True, axis=0)
        flips = so1 != so2
        err = max(float(np.abs(d1 - d2).max()), float(np.abs(s1 - s2).max()))
        ok = (np.array_equal(i1, i2) and np.array_equal(o1, o2) and np.array_equal(i2[:, 0], planted)
              and np.allclose(d2, d1, rtol=1e-5, atol=1e-6)
              and np.allclose(s2, s1, rtol=1e-5, atol=1e-6) and not (flips & top).any())
        check(ok, f"GalleryIndex sw {sw}: sharded top-10 or scores differ (max |dd| {err:.3e}, "
              f"{int(flips.sum())} orientation flips, {int((flips & top).sum())} in the top-10)")
        log(f"    sw {sw}, Q 8: search_sharded(k=10) == search (indices, orientations; distances "
            f"max |dd| {err:.3e}, rtol 1e-5 atol 1e-6 with score_all too), top-1 == planted; "
            f"score_all_sharded: {int(flips.sum())} of {flips.size} orientations differ from "
            f"score_all, {int((flips & top).sum())} in the top-10; search {t1 * 1e3:.3f} ms, "
            f"search_sharded {t2 * 1e3:.3f} ms, score_all {t3 * 1e3:.3f} ms, score_all_sharded "
            f"{t4 * 1e3:.3f} ms ({card})")
    del index, embeds
    torch.cuda.empty_cache()

    # (e) VectorIndex at 100,000 x 4096 and x 1536
    gen = torch.Generator(device=device).manual_seed(37)
    for dim in (RANK_D, BASE_D):
        gal = lattice(gen, (INDEX_TILES, dim), device)
        planted_v = torch.randperm(INDEX_TILES, generator=gen, device=device)[:8]
        q = planted_queries(gen, gal, planted_v, torch.full((8,), 0.125, device=device))
        q, embeds, planted_v = q.cpu().numpy(), gal.cpu().numpy(), planted_v.cpu().numpy()
        del gal
        vindex = VectorIndex(embeds, device=device)
        vindex.place_sharded(mesh)
        vindex.search(q, k=10)  # the first call uploads the gallery
        (i1, d1), t1 = timed(lambda: vindex.search(q, k=10))
        (i2, d2), t2 = timed(lambda: vindex.search_sharded(q, k=10))
        s1, t3 = timed(lambda: vindex.score_all(q))
        s2, t4 = timed(lambda: vindex.score_all_sharded(q))
        ok = (np.array_equal(i1, i2) and np.array_equal(d1, d2) and np.array_equal(s1, s2)
              and np.array_equal(i2[:, 0], planted_v))
        check(ok, f"VectorIndex D {dim}: sharded results differ")
        log(f"    VectorIndex {INDEX_TILES} x {dim} lattice vectors: search_sharded(k=10) == "
            f"search, score_all_sharded == score_all, bit for bit: {ok}; top-1 == planted; "
            f"search {t1 * 1e3:.3f} ms, search_sharded {t2 * 1e3:.3f} ms, score_all "
            f"{t3 * 1e3:.3f} ms, score_all_sharded {t4 * 1e3:.3f} ms ({card})")
        del vindex, embeds
        torch.cuda.empty_cache()

    # (f) the daemon at fov_experiment("witw", 70), bf16 and --int8, in process
    cfg_witw = fov_experiment("witw", 70)
    rng = np.random.default_rng(38)
    photos = [png_bytes(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
              for _ in range(SHARD_REQUESTS)]
    for precision, int8, mods in (("bf16", False, ["conv3x3"]), ("int8", True, list(INT8_MODULES))):
        base = indexes[precision]
        plain = serve_tool.GeolocateService(base, cfg_witw, serve_params, int8=int8)
        want = [plain.geolocate(p, k=5) for p in photos]
        sharded = serve_tool.GeolocateService(GalleryIndex(base.embeds, base.meta, device),
                                              cfg_witw, serve_params, int8=int8, mesh=mesh)
        seen = []
        real_embed = sharded._embed

        def recording_embed(imgs, real_embed=real_embed, seen=seen):
            out = real_embed(imgs)
            seen.append((imgs, out))
            return out

        sharded._embed = recording_embed
        (got, dt), made = count(lambda: timed(lambda: [sharded.geolocate(p, k=5)
                                                       for p in photos]))
        check(all(made[n] > 0 for n in mods), f"{precision} daemon(mesh=) launches {made}")
        same = all([r["tile"] for r in g] == [r["tile"] for r in w]
                   and [r["orientation_deg"] for r in g] == [r["orientation_deg"] for r in w]
                   and np.allclose([r["distance"] for r in g], [r["distance"] for r in w],
                                   rtol=1e-5, atol=1e-6) for g, w in zip(got, want))
        check(same, f"{precision} daemon(mesh=) answers differ from the unsharded daemon's")
        health = sharded.health()
        check(health["sharded_devices"] == 2 and plain.health()["sharded_devices"] == 1,
              f"{precision} health {health}")
        batches_seen, worst = check_daemon_embeds(sharded, seen, int8)
        log(f"    daemon {precision}, GeolocateService(mesh=) on [18]'s {len(base)}-tile index: "
            f"{SHARD_REQUESTS} requests (k=5, one at a time) in {dt:.3f} s ({card}); answers == "
            f"the unsharded daemon's {same}; sharded_devices {health['sharded_devices']}; "
            f"launches { {n: made[n] for n in mods} }; its embeddings vs the plain kernels: "
            f"{'max |d emb|' if int8 else 'cosine min'} {worst:.6g}")
        plain.close()
        sharded.close()

    # (g) [21]'s strip swept warm on the mesh (its --int8 index cache)
    try:
        photos = [str(HEATMAP_DIR / f"photo{k}.png") for k in range(2)]
        out_csv = HEATMAP_DIR / "int8_mesh.csv"
        scored = []
        real_score = GalleryIndex.score_all_sharded

        def record_score(index, *args, **kwargs):
            scored.append(len(index))
            return real_score(index, *args, **kwargs)

        GalleryIndex.score_all_sharded = record_score
        try:
            (_, dt), made = count(lambda: timed(lambda: heatmap.sweep(
                str(HEATMAP_DIR / "03_paris.tif"), photos, str(out_csv),
                sweep_bounds(SWEEP_SIDE), 225.0, 56.25, 70,
                checkpoint_dir=str(HEATMAP_DIR / "weights"),
                index_cache=str(HEATMAP_DIR / "tiles.npz"), int8=True, verbose=False,
                device=device, mesh=mesh)))
        finally:
            GalleryIndex.score_all_sharded = real_score
        header, rows = read_sweep_csv(out_csv)
        _, warm = read_sweep_csv(HEATMAP_DIR / "int8_warm.csv")
        got_d, want_d = (np.asarray([r[4] for r in x], np.float32) for x in (rows, warm))
        flips = sum(a[3] != b[3] for a, b in zip(rows, warm))
        ok = (header == CSV_HEADER and len(rows) == len(warm) and scored == [SWEEP_SIDE ** 2]
              and [r[:3] for r in rows] == [r[:3] for r in warm] and flips == 0
              and np.allclose(got_d, want_d, rtol=1e-5, atol=1e-6))
        check(ok, f"sweep(mesh=) CSV differs from [21]'s warm int8 CSV: {flips} orientations, "
              f"max |dd| {float(np.abs(got_d - want_d).max()):.3e}, scored {scored}")
        check(all(made[n] > 0 for n in INT8_MODULES), f"sweep(mesh=) launches {made}")
        log(f"    heatmap.sweep(mesh=), [21]'s {SWEEP_SIDE ** 2}-tile strip warm with its --int8 "
            f"cache: {dt:.3f} s ({card}); score_all_sharded over {scored} tiles; "
            f"{len(rows)} rows: photo, x, y equal to the warm single-device CSV's, "
            f"{flips} orientations differ, dissimilarity max |dd| "
            f"{float(np.abs(got_d - want_d).max()):.3e} (rtol 1e-5, atol 1e-6); launches "
            f"{ {n: made[n] for n in INT8_MODULES} }")
    finally:
        shutil.rmtree(HEATMAP_DIR, ignore_errors=True)
    log(f"    sharded-path launches ([30]): {launches}")
    if failures:
        raise AssertionError(f"[30] {len(failures)} check(s) failed: {failures}")
    return launches


DP_DIR = Path(__file__).resolve().parent / ".smoke_dp"
DP_TIMEOUT = 420  # seconds for the two worker processes of [31] (b)
DP_SEED = 40  # the batches of [31] (a) and (b)
DP_STEP_SEED = 7  # the train step's generator in (a) and (b)


def dp_grads(state):
    """A state's gradients, {tower: {name: tensor}}, after a train step."""
    return {t: {k: p.grad.detach().clone() for k, p in state.params[t].items()
                if p.grad is not None} for t in state.params}


def grad_agreement(got, want):
    """(least cosine, largest |norm ratio - 1|) over the towers' whole
    gradients, and (least cosine, its tensor) over single tensors."""
    cos, ratio, worst = 1.0, 0.0, (2.0, "")
    for t in want:
        g = torch.cat([got[t][k].flatten().double() for k in sorted(want[t])])
        w = torch.cat([want[t][k].flatten().double() for k in sorted(want[t])])
        cos = min(cos, float(g @ w / (g.norm() * w.norm())))
        ratio = max(ratio, abs(float(g.norm() / w.norm()) - 1.0))
        for k in want[t]:
            a, b = got[t][k].flatten().double(), want[t][k].flatten().double()
            worst = min(worst, (float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300)),
                                f"{t}/{k}"))
    return cos, ratio, worst


# The least per-tower cosine of a bf16 DP gradient to one device's bf16 one
# in [31] (c) (FOV's, in (a), is held at 0.999). It sits between the readings
# of sound steps on [31]'s data on an H100 (SAFA 0.995613 in five runs, where
# each shard's bf16 weight gradient is rounded before the shards' sum and the
# shards' shares cancel about 100-fold; the baseline 0.999760 in five runs
# with f64 sums and 0.998298 with per-row moments) and those of the planted
# fault of per-shard losses (SAFA 0.982044, baseline 0.954349).
DP_BF16_LIMIT = 0.99


@contextlib.contextmanager
def per_shard_losses(pipe, shards: int = 2):
    """A planted fault: ``pipe``'s data-parallel loss replaced by the mean of
    each shard's own in-batch loss (plain DDP's), not the global batch's."""
    global_loss = pipe._loss

    def loss(s_emb, o_emb, valid):
        parts = zip(s_emb.chunk(shards), o_emb.chunk(shards), valid.chunk(shards))
        return sum(global_loss(s, o, v)[0] for s, o, v in parts) / shards, {}

    pipe._loss = loss
    try:
        yield
    finally:
        del pipe._loss


@contextlib.contextmanager
def one_shard_only(pipe, keep: int):
    """``pipe``'s data-parallel step with every shard's embeddings but
    shard ``keep``'s detached: its gradient is that shard's share of the
    global loss's."""
    embed = pipe._embed_shards

    def shards(*args):
        return tuple([x if i == keep else x.detach() for i, x in enumerate(parts)]
                     for parts in embed(*args))

    pipe._embed_shards = shards
    try:
        yield
    finally:
        del pipe._embed_shards


def state_digest(state) -> str:
    """A hash of a state's params and Adam moments."""
    import hashlib

    h = hashlib.sha256()
    for t in sorted(state.params):
        for k in sorted(state.params[t]):
            h.update(state.params[t][k].detach().cpu().numpy().tobytes())
    for st in state.optimizer.state.values():
        for k in sorted(st):
            h.update(st[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_batches(cfg, n: int):
    rng = np.random.default_rng(DP_SEED)
    return [raw_batch(rng, cfg, 64) for _ in range(n)]


def dp_families():
    """[31] (c)'s steps, (family, pipeline class, config, batch): the
    baseline on a straggler of 15 (BatchNorm's global statistics) and SAFA
    at batch 32."""
    rng = np.random.default_rng(42)
    base, safa = baseline_experiment("cvusa"), safa_experiment("cvusa", 360)
    return [("baseline", BaselinePipeline, base, baseline_batch(rng, base, 15)),
            ("SAFA", SafaPipeline, safa, raw_batch(rng, safa, 32))]


def f32_config(cfg):
    """``cfg`` with f32 towers."""
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))


def dp_worker(rank: int, count: int, port: int, workdir: str) -> int:
    """[31] (b): one of ``count`` processes over Gloo, each on cuda:0,
    running tests/mp_worker.py's contract at full width; rank 0 writes
    ``dp_worker.json`` into ``workdir``."""
    from witw_tpu_torch.parallel import (global_batch_from_local, initialize_distributed,
                                         process_count)
    import torch.distributed as dist

    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"127.0.0.1:{port}", count, rank, backend="gloo", timeout=DP_TIMEOUT)
    mesh = make_mesh(devices=[device])
    out = {"process_count": process_count(), "mesh": repr(mesh)}
    fused_match.launches = conv3x3.launches = 0
    cfg = fov_experiment("cvusa", 360)
    pipeline = FovPipeline(cfg, device)
    batch = dp_batches(cfg, 1)[0]
    rows = 64 // count
    gb = global_batch_from_local({k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()},
                                 mesh)
    out["layout"] = [gb.start, gb.rows, gb.count, len(gb)]
    state = pipeline.init_state(torch.Generator().manual_seed(cfg.train.seed))
    state, metrics = pipeline.train_step(state, gb, torch.Generator().manual_seed(DP_STEP_SEED))
    out["loss"] = float(metrics["loss"])
    if rank == 0:
        torch.save({t: {k: g.cpu() for k, g in gs.items()} for t, gs in dp_grads(state).items()},
                   os.path.join(workdir, "grads.pt"))
    steps = [global_batch_from_local({k: v[rank * rows:(rank + 1) * rows]
                                      for k, v in b.items()}, mesh) for b in dp_batches(cfg, 3)]
    step_of = iter(range(10**9))
    out["step_ms"] = cuda_ms(lambda: pipeline.train_step(
        state, steps[next(step_of) % 3], torch.Generator().manual_seed(1)), 3, 3)
    out["digest"] = [None] * count
    mine = state_digest(state)

    # the baseline (BatchNorm's statistics over both processes' rows: 8 and 7
    # of the straggler of 15) and SAFA (16 and 16), f32 towers, held in (c)
    families = {}
    for family, make, family_cfg, fbatch in dp_families():
        fpipe = make(f32_config(family_cfg), device)
        lo, hi = np.array_split(np.arange(len(fbatch["surface"])), count)[rank][[0, -1]]
        fgb = global_batch_from_local({k: v[lo:hi + 1] for k, v in fbatch.items()}, mesh)
        fstate, fm = fpipe.train_step(
            fpipe.init_state(torch.Generator().manual_seed(family_cfg.train.seed)), fgb,
            torch.Generator().manual_seed(DP_STEP_SEED))
        families[family] = {"loss": float(fm["loss"]), "layout": [fgb.start, fgb.rows, fgb.count],
                            "digest": state_digest(fstate)}
        if rank == 0:
            torch.save({t: {k: g.cpu() for k, g in gs.items()} for t, gs in
                        dp_grads(fstate).items()}, os.path.join(workdir, f"{family}.pt"))
        del fpipe, fstate
    torch.cuda.empty_cache()

    o, s = planted_embeddings(np.random.default_rng(41), 1024, 4, 64, 16, 64)
    out["ranks"] = FovGalleryEvaluator(mesh=mesh, use_fused=True, query_block=128,
                                       shard_gallery=True).ranks(o, s).tolist()
    out["ranks_split"] = FovGalleryEvaluator(mesh=mesh, use_fused=True,
                                             query_block=128).ranks(o, s).tolist()
    index = GalleryIndex(o, device=device)
    index.place_sharded(mesh, gallery_chunk=256, max_k=16)
    top_i, top_d, top_o = index.search_sharded(s[:64, :, :12], k=10)
    out.update(search_i=top_i.tolist(), search_d=top_d.tolist(), search_o=top_o.tolist())

    best = Checkpointer(os.path.join(workdir, "ckpt"))
    written = best.save("best", state, {"val_loss": out["loss"], "step": state.step})
    if (written is None) != (rank != 0):
        raise AssertionError(f"rank {rank}: save returned {written}")
    own = Checkpointer(os.path.join(workdir, f"ckpt_local_{rank}"))
    own.save_step(state, state.step, {"epoch": 1})
    own.wait()
    if os.path.isdir(own.directory) != (rank == 0):
        raise AssertionError(f"rank {rank} created {own.directory}")
    fresh = pipeline.init_state(torch.Generator().manual_seed(99))
    restored = own.restore_latest(fresh)
    diff = max(float((restored.params[t][k] - state.params[t][k]).abs().max())
               for t in state.params for k in state.params[t])
    if rank == 0:
        back = best.restore("best", pipeline.init_state(torch.Generator().manual_seed(98)))
        out["ckpt_roundtrip_max"] = max(float((back.params[t][k] - state.params[t][k]).abs().max())
                                        for t in state.params for k in state.params[t])
    views = [None] * count
    dist.all_gather_object(views, {"digest": mine, "restore_latest_max": diff,
                                   "families": families,
                                   "loss": out["loss"], "ranks": out["ranks"],
                                   "launches": {"fused_match": fused_match.launches,
                                                "conv3x3": conv3x3.launches}})
    if rank == 0:
        out["digest"] = [v["digest"] for v in views]
        out["restore_latest_max"] = [v["restore_latest_max"] for v in views]
        out["same_loss_and_ranks"] = all(v["loss"] == views[0]["loss"]
                                         and v["ranks"] == views[0]["ranks"] for v in views)
        out["launches"] = [v["launches"] for v in views]
        out["families"] = [v["families"] for v in views]
        with open(os.path.join(workdir, "dp_worker.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    print(f"DP_WORKER_{rank}_OK", flush=True)
    return 0


def run_dp_workers(count: int = 2):
    """Start ``count`` dp_worker processes (this script, a port from the
    OS), wait for both within DP_TIMEOUT, kill both if either overruns;
    returns rank 0's JSON. Raises if a worker fails or times out."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = Path(__file__).resolve()
    procs = [subprocess.Popen([sys.executable, str(script), "--dp-worker", str(r), str(count),
                               str(port), str(DP_DIR)], cwd=str(script.parent),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(count)]
    outs = []
    try:
        deadline = time.monotonic() + DP_TIMEOUT
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DP_WORKER_{r}_OK" not in out:
            raise AssertionError(f"[31] worker {r} exited {p.returncode}:\n{out[-6000:]}")
    with open(DP_DIR / "dp_worker.json") as f:
        return json.load(f)


def phase_dp(card, device):
    """[31] Data-parallel training and the multi-process runtime at full
    CVUSA width on a mesh naming the card twice: (a) one process, the DP
    train step (a batch of 64 and a straggler of 63) and train(mesh=)
    against one device, then loop.test(mesh=) on the trained towers; (b)
    two processes over Gloo, both on the card, with (c)'s f32 steps; (c)
    the baseline and SAFA DP steps in f32 and bf16, each with a planted
    fault that must fail. Every check runs and is logged; the phase raises at the end
    if any failed. Returns the launches of the fused match and the conv
    kernel on its paths."""
    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[device, device])
    log(f"[31] data-parallel training over make_mesh(devices=[{device}, {device}]): {mesh} "
        f"(one card named twice; Gloo for the two processes: NCCL refuses two ranks on one "
        f"GPU) ({card})")
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir()
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            log(f"    FAILED: {what}")

    launches = {"fused_match": 0, "conv3x3": 0}

    def count(fn):
        fused_match.launches = conv3x3.launches = 0
        out = fn()
        torch.cuda.synchronize()
        made = {"fused_match": fused_match.launches, "conv3x3": conv3x3.launches}
        for n, c in made.items():
            launches[n] += c
        return out, made

    def fresh(pipe):
        return pipe.init_state(torch.Generator().manual_seed(pipe.cfg.train.seed))

    def step(pipe, batch):
        return pipe.train_step(fresh(pipe), batch, torch.Generator().manual_seed(DP_STEP_SEED))

    def shard_rounding(pipe, batch, g_sum):
        """Why bf16 DP gradients depart from one device's: the f32 DP
        step's gradient ``g_sum`` split into each shard's share, each share
        rounded to bf16 before their sum (as a shard's bf16 weight gradient
        is) against the sum rounded once (as one device's is); and how much
        the shares cancel, (|g_1| + |g_2|) / |g_1 + g_2|, at the tensor
        the rounding moves most."""
        gb = next(iter(loop.device_prefetch([batch], None, mesh=mesh)))[0]
        shares = []
        for keep in range(len(gb)):
            with one_shard_only(pipe, keep):
                shares.append(dp_grads(step(pipe, gb)[0]))
        bf16 = lambda g: g.to(torch.bfloat16).to(torch.float32)  # noqa: E731
        twice = {t: {n: sum(bf16(sh[t][n]) for sh in shares) for n in g_sum[t]} for t in g_sum}
        once = {t: {n: bf16(g_sum[t][n]) for n in g_sum[t]} for t in g_sum}
        cos, _, (t_cos, name) = grad_agreement(twice, once)
        t, n = name.split("/", 1)
        cancel = sum(float(sh[t][n].norm()) for sh in shares) / float(g_sum[t][n].norm())
        median = statistics.median(
            sum(float(sh[t][n].norm()) for sh in shares) / max(float(g_sum[t][n].norm()), 1e-30)
            for t in g_sum for n in g_sum[t])
        whole, _, _ = grad_agreement({t: {n: sum(sh[t][n] for sh in shares) for n in g_sum[t]}
                                      for t in g_sum}, g_sum)
        log(f"    SAFA's f32 DP gradient as the sum of its two shards' shares (their sum at "
            f"cosine {whole:.6f} to the step's): each share rounded to bf16 before the sum, "
            f"against the sum rounded once, per tower least cosine {cos:.6f}, least tensor "
            f"{t_cos:.6f} ({name}), where the shares cancel {cancel:.1f}-fold "
            f"((|g_1| + |g_2|) / |g_1 + g_2|; median over tensors {median:.1f})")

    def one_vs_dp(name, pipe, batch, limit=0.999, fault=False):
        """The DP step and one device's on ``batch`` from the same state and
        generator: the loss within rtol 1e-3 and each tower's gradient at
        cosine >= ``limit`` and a norm ratio within 1e-2 of 1. With
        ``fault``, the planted fault of plain DDP (each shard's own
        in-batch loss, averaged) must fail the same gradient check. Returns
        (one device's gradients, its loss, the DP step's gradients,
        launches)."""
        one, l_one = step(pipe, batch)
        g_one = dp_grads(one)
        gb = next(iter(loop.device_prefetch([batch], None, mesh=mesh)))[0]
        (dp, l_dp), made = count(lambda: step(pipe, gb))
        g_dp = dp_grads(dp)
        l_one, l_dp = float(l_one["loss"]), float(l_dp["loss"])
        cos, ratio, (t_cos, t_name) = grad_agreement(g_dp, g_one)
        check(abs(l_dp / l_one - 1.0) <= 1e-3, f"{name}: loss {l_dp} vs one device {l_one}")
        check(cos >= limit and ratio <= 1e-2, f"{name}: gradients cos {cos} (>= {limit}), "
              f"|norm ratio - 1| {ratio}")
        note = ""
        if fault:
            with per_shard_losses(pipe):
                g_fault = dp_grads(step(pipe, gb)[0])
            f_cos, f_ratio, _ = grad_agreement(g_fault, g_one)
            check(f_cos < limit or f_ratio > 1e-2, f"{name}: the planted fault passed the check: "
                  f"cos {f_cos}, |norm ratio - 1| {f_ratio}")
            note = (f"; planted fault (per-shard losses): cosine {f_cos:.6f}, |norm ratio - 1| "
                    f"{f_ratio:.2e} (fails)")
        log(f"    {name}: loss {l_dp:.6f} vs one device {l_one:.6f} (rel {abs(l_dp / l_one - 1):.2e},"
            f" rtol 1e-3); first-step gradients against one device's, per tower, least cosine "
            f"{cos:.6f} (>= {limit}), largest |norm ratio - 1| {ratio:.2e} (<= 1e-2); least tensor "
            f"cosine {t_cos:.6f} ({t_name}){note}; launches {made}")
        return g_one, l_one, g_dp, made

    # (a) one process, full width, batch 64
    cfg = fov_experiment("cvusa", 360)
    pipeline = FovPipeline(cfg, device)
    batches = dp_batches(cfg, 5)
    g_one, l_one, _, made = one_vs_dp("FOV DP step, batch 64 (two shards of 32)", pipeline,
                                      batches[0], fault=True)
    check(made["conv3x3"] > 0, f"the FOV DP step launched no conv3x3_bf16: {made}")
    one_vs_dp("FOV DP step, a straggler of 63 (padded to 64)", pipeline,
              {k: v[:63] for k, v in batches[1].items()})
    staged = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in batches[:3]]
    sharded = [next(iter(loop.device_prefetch([b], None, mesh=mesh)))[0] for b in batches[:3]]
    state_one, state_dp = fresh(pipeline), fresh(pipeline)
    step_of = iter(range(10**9))
    gen = torch.Generator().manual_seed(1)
    ms_one = cuda_ms(lambda: pipeline.train_step(state_one, staged[next(step_of) % 3], gen), 4, 5)
    ms_dp = cuda_ms(lambda: pipeline.train_step(state_dp, sharded[next(step_of) % 3], gen), 4, 5)
    log(f"    train step, batch 64, staged batches (CUDA events, median of 5 runs of 4 steps): "
        f"one device {ms_one:.3f} ms ({64e3 / ms_one:.2f} pairs/s), DP on the card twice "
        f"{ms_dp:.3f} ms ({64e3 / ms_dp:.2f} pairs/s) ({card})")
    del state_one, state_dp, staged, sharded

    epoch_cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=1))
    runs = {}
    for name, m in (("one", None), ("mesh", mesh)):
        ckpt = Checkpointer(str(DP_DIR / f"train_{name}"))
        run = lambda m=m, ckpt=ckpt: timed(lambda: loop.train(  # noqa: E731
            epoch_cfg, pipeline, batches[:4], batches[4:], checkpointer=ckpt, verbose=False,
            mesh=m))
        runs[name] = (count(run) if m is not None else (run(), None)) + (ckpt,)
    ((s_one, dt_one), _, c_one), ((s_dp, dt_dp), made, c_dp) = runs["one"], runs["mesh"]
    lr = cfg.train.optim.learning_rate
    worst = max(float(((s_dp.params[t][k] - s_one.params[t][k]).abs()
                       - 1e-3 * s_one.params[t][k].abs()).max().detach())
                for t in s_one.params for k in s_one.params[t])
    check(s_dp.step == s_one.step == 4 and worst <= 2.5 * lr * 4,
          f"train(mesh=) params after the epoch: step {s_dp.step}, excess over rtol 1e-3 "
          f"{worst:.3e} (bound {2.5 * lr * 4:.1e})")
    check(made["conv3x3"] > 0, f"train(mesh=) launched no conv3x3_bf16: {made}")
    check(abs(c_dp.best_val_loss() / c_one.best_val_loss() - 1.0) <= 1e-3,
          f"best val loss {c_dp.best_val_loss()} vs {c_one.best_val_loss()}")
    log(f"    train(mesh=) one epoch (4 train steps of 64, 1 val step): {dt_dp:.3f} s, one device "
        f"{dt_one:.3f} s ({card}); params after the epoch beyond rtol 1e-3 by at most "
        f"{worst:.3e} ({worst / lr:.2f} lr); best val loss {c_dp.best_val_loss():.6f} vs "
        f"{c_one.best_val_loss():.6f}; launches {made}")

    tower = s_dp.params["overhead"]
    tied = {"surface": tower, "overhead": tower}
    eval_cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, batch_size=128))
    planted = planted_batches(eval_cfg, SHARD_PAIRS, 128, 32, device)
    (_, ranks_one), t_one = timed(lambda: loop.test_ranks(eval_cfg, pipeline, planted, tied,
                                                          verbose=False))
    ((_, ranks_dp), t_dp), made = count(lambda: timed(lambda: loop.test_ranks(
        eval_cfg, pipeline, planted, tied, verbose=False, mesh=mesh)))
    check(np.array_equal(ranks_dp, ranks_one) and made["fused_match"] > 0,
          f"loop.test(mesh=) on the trained towers: ranks differ on "
          f"{int((ranks_dp != ranks_one).sum())}; launches {made}")
    log(f"    loop.test(mesh=) on the DP-trained towers (tied), {SHARD_PAIRS} planted pairs: ranks "
        f"== one device's {np.array_equal(ranks_dp, ranks_one)} (mean {ranks_dp.mean():.4f}); "
        f"{t_dp:.3f} s, one device {t_one:.3f} s ({card}); launches {made}")
    del runs, s_one, s_dp, tied, planted

    # (b) two processes over Gloo, both on the card
    o_pl, s_pl = planted_embeddings(np.random.default_rng(41), 1024, 4, 64, 16, 64)
    ranks_ref = FovGalleryEvaluator(use_fused=True, query_block=128, device=device).ranks(o_pl, s_pl)
    ref_i, ref_d, ref_o = GalleryIndex(o_pl, device=device).search(s_pl[:64, :, :12], k=10)
    torch.cuda.empty_cache()
    got, dt = timed(run_dp_workers)
    grads = torch.load(DP_DIR / "grads.pt")
    cos, ratio, _ = grad_agreement({t: {k: g.to(device) for k, g in gs.items()}
                                    for t, gs in grads.items()}, g_one)
    check(got["process_count"] == 2 and got["layout"] == [0, 64, 64, 1],
          f"workers: {got['process_count']} processes, layout {got['layout']}")
    check(abs(got["loss"] / l_one - 1.0) <= 1e-3 and cos >= 0.999 and ratio <= 1e-2,
          f"two processes: loss {got['loss']} vs {l_one}, gradients cos {cos}, ratio {ratio}")
    check(len(set(got["digest"])) == 1 and got["same_loss_and_ranks"],
          "the processes' params, moments, losses or ranks differ")
    check(got["ranks"] == ranks_ref.tolist() and got["ranks_split"] == ranks_ref.tolist(),
          "two-process ranks differ from one device's")
    check(got["search_i"] == ref_i.tolist() and got["search_o"] == ref_o.tolist()
          and np.allclose(got["search_d"], ref_d, rtol=1e-5, atol=1e-6),
          "two-process search_sharded differs from one device's search")
    check(got["ckpt_roundtrip_max"] == 0.0 and got["restore_latest_max"] == [0.0, 0.0],
          f"checkpoints: round trip {got['ckpt_roundtrip_max']}, restore_latest broadcast "
          f"{got['restore_latest_max']}")
    worker_launches = {n: sum(v[n] for v in got["launches"]) for n in launches}
    check(all(worker_launches.values()), f"the workers launched {worker_launches}")
    for n, c in worker_launches.items():
        launches[n] += c
    log(f"    two processes over Gloo ({got['mesh']}), 32 rows each: loss {got['loss']:.6f} vs one "
        f"device {l_one:.6f}; gradients least cosine {cos:.6f}, |norm ratio - 1| {ratio:.2e}; "
        f"params and moments identical on both {len(set(got['digest'])) == 1}; ranks "
        f"(gallery-resident and query-split, 1024 planted) == one device's "
        f"{got['ranks'] == ranks_ref.tolist()}; search_sharded == search "
        f"{got['search_i'] == ref_i.tolist()}; checkpoint round trip {got['ckpt_roundtrip_max']}, "
        f"restore_latest broadcast {got['restore_latest_max']}; DP step {got['step_ms']:.3f} ms "
        f"per process (CUDA events); workers {dt:.1f} s in all; launches {got['launches']} "
        f"({card})")

    # (c) the baseline (a straggler: global BatchNorm) and SAFA, f32 towers
    # (TF32 off) and bf16, each against one device's; (b)'s two processes on
    # the f32 steps
    for k, (family, make, family_cfg, batch) in enumerate(dp_families()):
        what = f"{len(batch['surface'])}" + (" (padded to 16)" if family == "baseline" else "")
        f32 = make(f32_config(family_cfg), device)
        g32, l32, g32_dp, _ = one_vs_dp(f"{family} DP step, f32 towers, batch {what}", f32, batch,
                                        fault=True)
        views = [v[family] for v in got["families"]]
        w_grads = {t: {n: g.to(device) for n, g in gs.items()}
                   for t, gs in torch.load(DP_DIR / f"{family}.pt").items()}
        w_cos, w_ratio, _ = grad_agreement(w_grads, g32)
        n = len(batch["surface"])
        layouts = [[int(r[0]), n, n] for r in np.array_split(np.arange(n), len(views))]
        check(abs(views[0]["loss"] / l32 - 1.0) <= 1e-3 and w_cos >= 0.999 and w_ratio <= 1e-2
              and len({v["digest"] for v in views}) == 1
              and [v["layout"] for v in views] == layouts,
              f"{family} over two processes: loss {views[0]['loss']} vs {l32}, gradients cos "
              f"{w_cos}, ratio {w_ratio}, layouts {[v['layout'] for v in views]}")
        log(f"    {family} DP step, f32 towers, over (b)'s two processes (rows from "
            f"{[v['layout'][0] for v in views]} of {n}): loss {views[0]['loss']:.6f} vs one "
            f"device {l32:.6f}; gradients least cosine {w_cos:.6f}, |norm ratio - 1| "
            f"{w_ratio:.2e}; params and moments identical on both "
            f"{len({v['digest'] for v in views}) == 1}")
        if family == "SAFA":
            shard_rounding(f32, batch, g32_dp)
        bf16 = make(family_cfg, device)
        g16, _, g16_dp, made = one_vs_dp(f"{family} DP step, bf16 towers, batch {what}", bf16,
                                         batch, DP_BF16_LIMIT, fault=True)
        # a sound step that differs only in batch size: one device on the
        # batch with an all-padding row added
        padded = {k: np.concatenate([v, np.zeros_like(v[:1])]) for k, v in batch.items()}
        padded["valid"] = np.arange(n + 1) < n
        p_cos, p_ratio, (p_t, p_name) = grad_agreement(dp_grads(step(bf16, padded)[0]), g16)
        log(f"    {family} bf16, one device on the batch with a padding row ({n + 1} rows) "
            f"against one device's step: per tower least cosine {p_cos:.6f}, |norm ratio - 1| "
            f"{p_ratio:.2e}; least tensor {p_t:.6f} ({p_name})")
        del bf16
        c_one, _, (t_one, n_one) = grad_agreement(g16, g32)
        c_dp, _, (t_dp, n_dp) = grad_agreement(g16_dp, g32)
        log(f"    {family} bf16 gradients against the f32 towers' one-device step, per tower "
            f"least cosine: one device {c_one:.6f}, DP {c_dp:.6f}; least tensor: one device "
            f"{t_one:.6f} ({n_one}), DP {t_dp:.6f} ({n_dp})")
        if family == "baseline":
            check(not any(made.values()), f"the baseline DP step launched a port kernel: {made}")
        else:
            check(made["conv3x3"] > 0, f"the SAFA DP step launched no conv3x3_bf16: {made}")
        del f32
    shutil.rmtree(DP_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"    [31] {time.perf_counter() - t_phase:.2f} s; launches on its paths {launches} ({card})")
    if failures:
        raise AssertionError(f"[31] {len(failures)} checks failed: {failures}")
    return launches


DATASET_DIR = Path(__file__).resolve().parent / ".smoke_dataset"
STRIP_SIDE = 8192  # pixels a side of [32]'s 8-band uint16 strip (1 GiB raw)
STRIP_BANDS = 8
STRIP_CORNER = (48.875, 2.300)  # (lat, lon) of its upper-left corner, near Paris
STRIP_BLANK_ROWS = 1000  # its top rows are nodata (zero)
DATASET_CITIES = ("paris", "rotterdam")  # both UTM 31N; paris is the held-out test city
# Photos planted per city, by the stage that must drop them: grey (2), dark
# ones the indoor classifier flags (3), preset ids (4), geotags off the strip
# (5), tiles over the nodata rows (6), and the ones that stay.
PLANTED = {"grey": 2, "indoor": 8, "removed": 4, "off_strip": 3, "blank": 4, "kept": 235}
PARITY_PAIRS = 256


def _tiff_entry(code: int, values, kind: str) -> tuple:
    """(code, type, count, packed values) of one classic-TIFF IFD entry."""
    fmt, ttype = {"H": ("H", 3), "I": ("I", 4), "d": ("d", 12)}[kind]
    return code, ttype, len(values), struct.pack(f"<{len(values)}{fmt}", *values)


def write_tiff_u16(path, blocks, height: int, width: int, bands: int, geotransform, epsg: int,
                   rows_per_strip: int = 64) -> None:
    """An uncompressed, chunky, little-endian uint16 GeoTIFF of height x width x
    bands, its pixels streamed from ``blocks`` (uint16 [rows, width, bands]
    arrays, top to bottom, each a whole number of strips but the last).
    ``epsg`` 4326: geographic; else a projected EPSG code."""
    nstrips = -(-height // rows_per_strip)
    strip_bytes = [min(rows_per_strip, height - s * rows_per_strip) * width * bands * 2
                   for s in range(nstrips)]
    model = (1024, 0, 1, 2, 2048, 0, 1, 4326) if epsg == 4326 else (1024, 0, 1, 1, 3072, 0, 1, epsg)
    geokeys = (1, 1, 0, 3) + model[:4] + (1025, 0, 1, 1) + model[4:]
    entries = [
        _tiff_entry(256, [width], "I"), _tiff_entry(257, [height], "I"),
        _tiff_entry(258, [16] * bands, "H"), _tiff_entry(259, [1], "H"),
        _tiff_entry(262, [1], "H"), _tiff_entry(273, [0] * nstrips, "I"),
        _tiff_entry(277, [bands], "H"),
        _tiff_entry(278, [rows_per_strip], "I"), _tiff_entry(279, strip_bytes, "I"),
        _tiff_entry(284, [1], "H"),
        _tiff_entry(33550, [geotransform[1], -geotransform[5], 0.0], "d"),
        _tiff_entry(33922, [0.0, 0.0, 0.0, geotransform[0], geotransform[3], 0.0], "d"),
        _tiff_entry(34735, list(geokeys), "H"),
    ]
    ifd_size = 2 + 12 * len(entries) + 4
    external = sum(len(e[3]) for e in entries if len(e[3]) > 4)
    data_at = 8 + ifd_size + external
    offsets = list(itertools.accumulate([data_at] + strip_bytes[:-1]))
    if offsets[-1] + strip_bytes[-1] >= 2 ** 32:
        raise ValueError("a classic TIFF holds less than 4 GiB")
    entries[5] = _tiff_entry(273, offsets, "I")  # the one value the layout sets
    ifd, tail = [struct.pack("<H", len(entries))], []
    at = 8 + ifd_size
    for code, ttype, count, packed in entries:
        if len(packed) <= 4:
            ifd.append(struct.pack("<HHI", code, ttype, count) + packed.ljust(4, b"\0"))
        else:
            ifd.append(struct.pack("<HHII", code, ttype, count, at))
            tail.append(packed)
            at += len(packed)
    ifd.append(struct.pack("<I", 0))
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8) + b"".join(ifd) + b"".join(tail))
        written = 0
        for block in blocks:
            block = np.ascontiguousarray(block, np.uint16)
            block.tofile(f)
            written += block.shape[0]
        if written != height or f.tell() != offsets[-1] + strip_bytes[-1]:
            raise AssertionError(f"{path}: wrote {written} of {height} rows")


def strip_geotransform(side: int = STRIP_SIDE):
    """EPSG:4326 geotransform of [32]'s strip: ~0.3 m pixels at its latitude."""
    lat, lon = STRIP_CORNER
    dlat = GSD / 111132.0
    dlon = GSD / (111320.0 * np.cos(np.radians(lat)))
    return np.array([lon, dlon, 0.0, lat, 0.0, -dlat])


def strip_blocks(device, rows: int = 1024):
    """[32]'s strip, drawn on the card a block of rows at a time: per band an
    offset of 150 * band plus noise below 1800, zero on the top rows."""
    gen = torch.Generator(device=device).manual_seed(32)
    offsets = torch.arange(STRIP_BANDS, device=device, dtype=torch.int16) * 150
    for y0 in range(0, STRIP_SIDE, rows):
        block = torch.randint(1, 1800, (rows, STRIP_SIDE, STRIP_BANDS), generator=gen,
                              device=device, dtype=torch.int16) + offsets
        block[:max(0, min(rows, STRIP_BLANK_ROWS - y0))] = 0
        yield block.cpu().numpy().view(np.uint16)


def dataset_photos(grid, rng):
    """(metadata records per city, photo files {relative path: array}, the
    preset ids to remove): [32]'s planted photos on the reprojected strip's
    grid, each city's sorted by northing (tiles in row order share the
    strip's decoded chunks)."""
    records, files, removed = {}, {}, []
    margin = 600  # pixels: a 750-pixel tile stays on the strip
    ident = 0
    for city in DATASET_CITIES:
        rows = []
        for kind, count in PLANTED.items():
            for _ in range(count):
                ident += 1
                row = (STRIP_BLANK_ROWS if kind == "blank"
                       else int(rng.integers(STRIP_BLANK_ROWS + 1000, grid.height - margin)))
                col = int(rng.integers(margin, grid.width - margin))
                lat, lon = geotiff.utm_to_wgs84(grid.e_min + (col + 0.5) * GSD,
                                                grid.n_max - (row + 0.5) * GSD, grid.epsg)
                if kind == "off_strip":
                    lat += 0.5
                if kind == "grey":
                    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
                elif kind == "indoor":
                    img = rng.integers(0, 40, (64, 96, 3), dtype=np.uint8)
                else:
                    img = rng.integers(120, 256, (64, 96, 3), dtype=np.uint8)
                if kind == "removed":
                    removed.append(str(ident))
                url = f"https://farm.example/{ident}_s3cr3t_m.jpg"
                # half the photos under {id}.jpg, half under the URL's basename
                name = f"{ident}.jpg" if ident % 2 else url.rsplit("/", 1)[-1]
                files[f"{city}/{name}"] = img
                rows.append((row, {"id": str(ident), "owner": f"o{ident}", "title": f"t {ident}",
                                   "datetaken": "2020-05-01 10:00:00", "latitude": f"{lat:.7f}",
                                   "longitude": f"{lon:.7f}", "accuracy": "16", "license": "4",
                                   "url_m": url}))
        records[city] = [r for _, r in sorted(rows, key=lambda t: t[0])]
    return records, files, removed


def phase_dataset(card, device):
    """[32] Dataset construction and the parity harness: (a) write a synthetic
    8-band uint16 strip near Paris in EPSG:4326; (b) convert it to 8 bits on
    the card (wv3_psms bands); (c) reproject it to EPSG:32631 at 0.3 m on the
    card; (d) both against their CPU paths on a crop and a block; (e)
    build_dataset.build on 512 planted photos with an indoor classifier; (f)
    road masks on the clipped tiles, heuristic and checkpoint; (g) the built
    train.csv through PairLoader into FovPipeline; (h) run_parity at full
    width. Returns the parity path's launches {counter: n}."""
    from PIL import Image

    t_phase = time.perf_counter()
    log(f"[32] dataset construction and the parity harness (work files in {DATASET_DIR.name}/)")
    shutil.rmtree(DATASET_DIR, ignore_errors=True)
    DATASET_DIR.mkdir()
    failures = []

    def check(ok: bool, what: str) -> None:
        log(f"    {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failures.append(what)

    # (a) the 16-bit strip
    strip16, strip8 = DATASET_DIR / "strip16.tif", DATASET_DIR / "strip8.tif"
    t0 = time.perf_counter()
    write_tiff_u16(strip16, strip_blocks(device), STRIP_SIDE, STRIP_SIDE, STRIP_BANDS,
                   strip_geotransform(), 4326)
    mpx = STRIP_SIDE * STRIP_SIDE / 1e6
    log(f"    (a) {STRIP_SIDE} x {STRIP_SIDE} x {STRIP_BANDS} uint16 strip, EPSG:4326 at ~{GSD} m, "
        f"{strip16.stat().st_size / 2**30:.3f} GiB, written in {time.perf_counter() - t0:.2f} s")

    # (b) 16 -> 8 bits on the card
    bands = convert_8bit.BAND_ORDERS["wv3_psms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(convert_8bit.convert_to_8bit(str(strip16), str(strip8), bands=bands, device=device),
          "convert_to_8bit converted the strip (zero fraction under 0.3)")
    t_convert = time.perf_counter() - t0
    with geotiff.GeoTiff(str(strip16)) as tif:
        sel = convert_8bit.as_tensor(tif.read(), device)[..., [b - 1 for b in bands]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scaled = convert_8bit.rescale_to_u8(sel)
    t_rescale = time.perf_counter() - t0
    ranges = [convert_8bit.band_percentiles(sel[..., i]) for i in range(3)]
    del sel
    with geotiff.GeoTiff(str(strip8)) as tif:
        check(bool(np.array_equal(tif.read(), scaled)), "the written 8-bit strip is rescale_to_u8's")
    del scaled
    log(f"    (b) convert_to_8bit bands {bands}: {t_convert:.3f} s for {mpx:.2f} Mpx, "
        f"{mpx / t_convert:.2f} Mpx/s (read, card, deflate write); rescale_to_u8 on the card "
        f"(upload done; percentiles, scale, download) {t_rescale:.3f} s, {mpx / t_rescale:.2f} "
        f"Mpx/s; (lo, hi) per band {ranges} ({card})")

    # (c) reprojection on the card
    utm = DATASET_DIR / "strip_utm.tif"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = reproject.reproject_to_utm(str(strip8), str(utm), 32631, GSD, device=device)
    t_warp = time.perf_counter() - t0
    out_mpx = grid.width * grid.height / 1e6
    log(f"    (c) reproject_to_utm -> EPSG:32631 at {GSD} m: {grid.width} x {grid.height} in "
        f"{t_warp:.3f} s, {out_mpx / t_warp:.2f} output Mpx/s (Lanczos-3, f64, blocks of 2048; "
        f"windowed reads and the deflate write included) ({card})")

    # (d) the card against the CPU path
    crop = DATASET_DIR / "crop16.tif"
    y0, x0 = STRIP_BLANK_ROWS - 200, STRIP_SIDE // 2 - 512
    with geotiff.GeoTiff(str(strip16)) as tif:
        window = tif.read_window(x0, y0, 1024, 1024)
        gt = tif.geotransform
    crop_gt = np.array([gt[0] + x0 * gt[1], gt[1], 0.0, gt[3] + y0 * gt[5], 0.0, gt[5]])
    write_tiff_u16(crop, [window], 1024, 1024, STRIP_BANDS, crop_gt, 4326)
    outs = {}
    for dev in (device, "cpu"):
        outs[str(dev)] = DATASET_DIR / f"crop8_{torch.device(dev).type}.tif"
        convert_8bit.convert_to_8bit(str(crop), str(outs[str(dev)]), bands=bands, device=dev)
    ranges_card = [convert_8bit.band_percentiles(window[..., b - 1], device=device) for b in bands]
    ranges_cpu = [convert_8bit.band_percentiles(window[..., b - 1], device="cpu") for b in bands]
    with geotiff.GeoTiff(str(outs[str(device)])) as a, geotiff.GeoTiff(str(outs["cpu"])) as b:
        crop_equal = bool(np.array_equal(a.read(), b.read()))
    check(ranges_card == ranges_cpu, f"1024^2 crop: (lo, hi) card == CPU {ranges_card}")
    check(crop_equal, "1024^2 crop: converted uint8 card == CPU")
    bx, by = grid.width // 2 - 256, grid.height // 2 - 256
    with geotiff.GeoTiff(str(strip8)) as src:
        t0 = time.perf_counter()
        cpu_block = reproject.warp_block(src, grid, bx, by, 512, 512, device="cpu")
        t_cpu_block = time.perf_counter() - t0
    with geotiff.GeoTiff(str(utm)) as out:
        card_block = out.read_window(bx, by, 512, 512)
        check(out.width == grid.width and out.height == grid.height
              and np.array_equal(out.geotransform, grid.geotransform), "the UTM file's grid")
    diff = np.abs(card_block.astype(np.int16) - cpu_block.astype(np.int16))
    off = float((diff > 0).mean())
    check(int(diff.max()) <= 1 and off <= 1e-4,
          f"512^2 block at ({by}, {bx}): card vs CPU max |d| {int(diff.max())}, "
          f"share off {off:.2e} (<= 1 on <= 1e-4; CPU block {t_cpu_block:.2f} s)")

    # (e) build_dataset on planted photos
    sat, meta, photos, built = (DATASET_DIR / n for n in ("sat", "meta", "photos", "built"))
    sat.mkdir()
    for city in DATASET_CITIES:
        os.link(utm, sat / strip_filename(city))
    records, files, removed = dataset_photos(grid, np.random.default_rng(32))
    for city, recs in records.items():
        (meta / city).mkdir(parents=True)
        (meta / city / "metadata.json").write_text(json.dumps(recs))
        (photos / city).mkdir(parents=True)
    for rel, img in files.items():
        Image.fromarray(img).save(photos / rel, format="PNG")
    classifier = torch.nn.Sequential(torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                                     torch.nn.Linear(3, 2))
    with torch.no_grad():
        classifier[2].weight.copy_(torch.tensor([[-1.0] * 3, [1.0] * 3]))  # dark -> class 0
        classifier[2].bias.zero_()
    torch.save(classifier, DATASET_DIR / "places.pth")
    (DATASET_DIR / "io_places.txt").write_text("indoor 1\noutdoor 2\n")
    indoor = build_dataset.torch_indoor_classifier(str(DATASET_DIR / "places.pth"),
                                                   str(DATASET_DIR / "io_places.txt"), device=device)
    seconds = {}
    t0 = time.perf_counter()
    table = build_dataset.build(str(meta), str(photos), str(sat), str(built), remove_ids=removed,
                                indoor_classifier=indoor, verbose=False, device=device,
                                stage_seconds=seconds)
    t_build = time.perf_counter() - t0
    n_cities = len(DATASET_CITIES)
    kept = PLANTED["kept"] * n_cities
    clipped = kept + PLANTED["blank"] * n_cities
    train = read_pair_paths(fov_experiment("witw", 70).data.dataset, str(built / "train.csv"))
    test_rows = read_pair_paths(fov_experiment("witw", 70).data.dataset, str(built / "test.csv"))
    check(len(table["id"]) == kept and len(train) == len(test_rows) == PLANTED["kept"],
          f"rows: dataset {len(table['id'])}, train {len(train)}, test {len(test_rows)} (planted "
          f"{kept}, {PLANTED['kept']} a city)")
    tiles_written = sorted((built / "overhead").iterdir())
    check(len(tiles_written) == clipped, f"{len(tiles_written)} tiles clipped (planted {clipped})")
    log(f"    (e) build_dataset.build, {sum(PLANTED.values()) * n_cities} photos: {t_build:.3f} s; "
        f"stage seconds {json.dumps({k: round(v, 4) for k, v in seconds.items()})}; clipping "
        f"{clipped / seconds['5']:.2f} tiles/s (750^2 from the deflated UTM strip) ({card})")

    # (f) road masks on the clipped tiles
    rates = {}
    for name, kw in (("heuristic", {}),
                     ("checkpoint", {"segmenter": None, "minmax": True})):
        if name == "checkpoint":
            torch.manual_seed(32)
            torch.save(torch.nn.Conv2d(3, 1, 3, padding=1), DATASET_DIR / "roads.pth")
            kw["segmenter"] = semantic_masks.torch_segmenter(str(DATASET_DIR / "roads.pth"), device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = semantic_masks.precompute_masks(str(built / "overhead"), str(DATASET_DIR / name),
                                            verbose=False, device=device, **kw)
        rates[name] = n / (time.perf_counter() - t0)
        check(n == clipped, f"{name} masks: {n} tiles")
    worst = 0.0
    for path in tiles_written[:8]:
        with geotiff.GeoTiff(str(path)) as tif:
            rgb = tif.read()[..., :3].astype(np.float32)
        a = semantic_masks.heuristic_road_mask(rgb, device=device)
        b = semantic_masks.heuristic_road_mask(rgb, device="cpu")
        worst = max(worst, float(np.abs(a - b).max()))
    check(worst <= 2e-4, f"heuristic mask on 8 tiles: card vs CPU max |d| {worst:.3e} (atol 2e-4)")
    log(f"    (f) precompute_masks: heuristic {rates['heuristic']:.2f} tiles/s, Conv2d(3, 1) "
        f"checkpoint {rates['checkpoint']:.2f} tiles/s (tile read and write included) ({card})")

    # (g) the built train.csv feeds a trainer
    cfg_witw = fov_experiment("witw", 70)
    rows = min(16, len(train))
    batch = next(iter(cli_common.build_loader(cfg_witw, train, shuffle=False, drop_last=False,
                                              batch_size=rows)))
    pipe = FovPipeline(cfg_witw, device)
    s_emb, o_emb = pipe.embed_step(pipe.init(torch.Generator().manual_seed(32)),
                                   {k: torch.as_tensor(batch[k]).to(device)
                                    for k in ("surface", "overhead")})
    torch.cuda.synchronize()
    check(s_emb.shape[0] == o_emb.shape[0] == rows and bool(torch.isfinite(s_emb).all())
          and bool(torch.isfinite(o_emb).all()),
          f"train.csv -> PairLoader -> FovPipeline.embed_step (witw, fov 70): surface "
          f"{tuple(s_emb.shape)}, overhead {tuple(o_emb.shape)}, finite")

    # (h) the parity harness at full width
    cfg = fov_experiment("cvusa", 360)
    csv_path = synthetic.write_synthetic_dataset(str(DATASET_DIR / "cvusa"), n=PARITY_PAIRS)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset=dataclasses.replace(
        cfg.data.dataset, test_csv=csv_path)), eval=dataclasses.replace(cfg.eval, batch_size=64))
    towers = FovPipeline(cfg, device).init(torch.Generator().manual_seed(33))
    pths = []
    for tower in ("surface", "overhead"):
        pths.append(str(DATASET_DIR / f"fov_360_{tower}_best.pth"))
        torch.save(reference_layout(towers[tower], "reference"), pths[-1])
    reset_kernel_counts()
    t0 = time.perf_counter()
    report = parity.run_parity(cfg, *pths, verbose=False, device=device)
    torch.cuda.synchronize()
    t_parity = time.perf_counter() - t0
    launches = {"conv3x3": conv3x3.launches, "fused_match": fused_match.launches}
    check(launches["conv3x3"] > 0 and launches["fused_match"] > 0,
          f"run_parity launched the conv kernel {launches['conv3x3']} and the fused match "
          f"{launches['fused_match']} times")
    pipe, params = parity.load_reference_towers(cfg, *pths, device=device)
    check(all(torch.equal(params[t][k], towers[t][k]) for t in towers for k in towers[t]),
          "load_reference_towers gives back the saved towers")
    loader_ = cli_common.build_loader(cfg, read_pair_paths(cfg.data.dataset, csv_path), False,
                                      False, 64)
    direct = loop.test(cfg, pipe, loader_, params=params, verbose=False)
    check(direct == report["witw_tpu"], f"run_parity metrics == loop.test's: {json.dumps(direct)}")
    ref = dict(report["witw_tpu"])
    same = parity.run_parity(cfg, *pths, reference_metrics=ref, verbose=False, device=device)
    off_by_one = parity.run_parity(cfg, *pths, reference_metrics=dict(ref, top_1=ref["top_1"] + 1.0),
                                   verbose=False, device=device)
    check(same["gate_pass"] is True and off_by_one["gate_pass"] is False,
          f"gate: PASS against its own metrics, FAIL against top_1 + 1 pt "
          f"(|delta| {same['recall1_delta_pt']}, {off_by_one['recall1_delta_pt']})")
    log(f"    (h) run_parity fov 360, {PARITY_PAIRS} pairs, bf16 towers at batch 64: "
        f"{t_parity:.3f} s; launches conv3x3_bf16 {launches['conv3x3']}, fused match "
        f"{launches['fused_match']} ({card})")

    shutil.rmtree(DATASET_DIR, ignore_errors=True)
    log(f"    [32] {time.perf_counter() - t_phase:.2f} s ({card})")
    if failures:
        raise AssertionError(f"[32] {len(failures)} check(s) failed: {failures}")
    return launches


def main() -> int:
    # 1. device
    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    # 2. build every kernel, one nvcc per source, all started together
    t0 = time.perf_counter()
    built = build_libraries(LIBRARIES)
    fused_match._lib()
    conv3x3._lib()
    log(f"[2] built {', '.join(p.name for p, _ in built.values())} with nvcc (sm_90a) "
        f"in {time.perf_counter() - t0:.2f} s")
    print_ptxas(built["fused_match"][1])
    for line in built["fused_match"][1].splitlines():
        if "wgmma" in line:  # ptxas reports wgmma it had to serialize
            log("    " + line.strip())
    check_wgmma_build("fused_match", built, "HGMMA", ("HGMMA",))

    # 3. kernel vs plain, f32, TF32 off
    log("[3] fused_corr_distance vs plain PyTorch "
        f"(rtol {RTOL}, atol {ATOL}; near ties: top-2 gap <= {TIE_REL}*|max|)")
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = {
        "main path": (128, 128, 4, 64, 16, 64),
        "fov 90": (128, 128, 4, 64, 16, 16),
        "ragged": (37, 5, 4, 64, 16, 64),
        "gallery block": (8832, 128, 4, 64, 16, 64),
    }
    inputs = {k: maps(gen, *v, device) for k, v in shapes.items()}
    max_abs_err = max(compare_kernel(k, *inputs[k]) for k in shapes)
    edges = {  # the card tests' edges, at full size
        "hc 6": (128, 128, 2, 64, 3, 64, "random"),
        "hc 20": (128, 128, 4, 64, 5, 64, "random"),
        "sw = W = 100": (64, 128, 2, 100, 8, 100, "random"),
        "sw 1": (128, 128, 4, 64, 16, 1, "random"),
        "G odd": (127, 128, 4, 64, 16, 64, "random"),
        "scaled 1e3": (128, 128, 4, 64, 16, 64, "scaled"),
        "exact ties": (128, 128, 4, 64, 16, 64, "tie"),
        "NaN in map 2": (128, 128, 4, 64, 16, 64, "nan"),
        "hc 128 (two channel chunks)": (128, 128, 4, 64, 32, 64, "random"),
        "W 128 (two channel chunks)": (128, 128, 4, 128, 16, 64, "random"),
        "W = sw = 256 (4 passes of 2 chunks)": (64, 128, 2, 256, 32, 256, "random"),
        "W 2048, sw 64, hc 16 (a window a pass)": (128, 128, 4, 2048, 4, 64, "random"),
        "W = sw = 2048, hc 16 (3 windows a pass)": (16, 128, 4, 2048, 4, 2048, "random"),
        "o, s 4 bytes off alignment": (128, 128, 1, 64, 56, 1, "offset"),
    }
    for name, (*shape, data) in edges.items():
        o, s = maps(gen, *shape, device)
        if data == "scaled":
            o, s = o * 1e3, s * 1e3
        elif data == "tie":
            o[:, :, shape[3] // 2:] = o[:, :, :shape[3] // 2]
        elif data == "nan":
            o[2, 1, 5, 3] = float("nan")
        elif data == "offset":  # views the wrapper passes on uncopied (h = 1, sw = 1)
            o = torch.empty(o.numel() + 1, device=device)[1:].view(o.shape).copy_(o)
            s = torch.empty(s.numel() + 1, device=device)[1:].view(s.shape).copy_(s)
        max_abs_err = max(max_abs_err, compare_kernel(name, o, s, data))
    del o, s

    # 4. the slice at full width
    fused_match.launches = 0
    conv3x3.launches = 0
    cfg = fov_experiment("cvusa", 360)
    pipeline = FovPipeline(cfg, device)
    params = pipeline.init(torch.Generator().manual_seed(0))
    batch = raw_batch(np.random.default_rng(0), cfg, 128)
    d360 = pipeline.forward_distance(params, batch)
    torch.cuda.synchronize()
    if d360.shape != (128, 128) or not bool(torch.isfinite(d360).all()):
        raise AssertionError(f"fov 360 distances: shape {tuple(d360.shape)}, finite "
                             f"{bool(torch.isfinite(d360).all())}")
    after_360 = fused_match.launches
    conv_360 = conv3x3.launches
    if after_360 < 1 or conv_360 < 1:
        raise AssertionError(f"forward_distance did not launch both kernels: fused match "
                             f"{after_360}, conv {conv_360}")
    cfg90 = fov_experiment("cvusa", 90)
    d90 = FovPipeline(cfg90, device).forward_distance(params, batch)
    torch.cuda.synchronize()
    if d90.shape != (128, 128) or not bool(torch.isfinite(d90).all()):
        raise AssertionError("fov 90 distances are not finite [128, 128]")
    if fused_match.launches <= after_360 or conv3x3.launches <= conv_360:
        raise AssertionError("fov 90 forward_distance did not launch both kernels")
    log(f"[4] forward_distance bf16 batch 128: fov 360 d [128, 128] mean {float(d360.mean()):.6f}; "
        f"fov 90 d [128, 128] mean {float(d90.mean()):.6f}; launches {fused_match.launches}")

    # 5. retrieval eval through the fused kernel
    n_eval, eval_batch = 1024, 64
    cfg_eval = fov_experiment("cvusa", 360)
    cfg_eval = cfg_eval.replace(eval=dataclasses.replace(cfg_eval.eval, batch_size=eval_batch))
    log(f"[5] train.loop.test on {n_eval} synthetic pairs, batches of {eval_batch}, use_fused=True")
    before_test, conv_before_test = fused_match.launches, conv3x3.launches
    metrics, ranks = loop.test_ranks(
        cfg_eval, pipeline, synthetic_loader(cfg_eval, n_eval, eval_batch, 2), params)
    launches, conv_launches_embed = fused_match.launches, conv3x3.launches
    if launches <= before_test or conv_launches_embed <= conv_before_test:
        raise AssertionError("test() did not launch both kernels")
    if ranks.shape != (n_eval,) or ranks.min() < 1 or ranks.max() > n_eval:
        raise AssertionError(f"ranks out of [1, {n_eval}]: {ranks.min()}..{ranks.max()}")
    if metrics_from_ranks(ranks) != metrics:
        raise AssertionError("test() metrics do not follow from its ranks")
    log(f"    metrics {json.dumps(metrics)}; fused match launches: test() "
        f"{launches - before_test}, main path {launches}; conv3x3_bf16 launches: test() "
        f"{conv_launches_embed - conv_before_test}, main path {conv_launches_embed}")

    # Checks past this point launch the kernel outside the counted main path.
    # A small full-geometry batch: GPU f32 against the same pipeline on the CPU.
    cfg32 = fov_experiment("cvusa", 360, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    small = raw_batch(np.random.default_rng(1), cfg32, 2)
    gpu32 = FovPipeline(cfg32, device).forward_distance(params, small).cpu()
    cpu_params = {t: {k: v.cpu() for k, v in p.items()} for t, p in params.items()}
    cpu32 = FovPipeline(cfg32, "cpu").forward_distance(cpu_params, small)
    ref_err = float((gpu32 - cpu32).abs().max())
    log(f"    f32 full geometry, batch 2: GPU (kernel) vs CPU (plain) max |dd| = {ref_err:.3e} (atol 1e-3)")
    if not ref_err <= 1e-3:
        raise AssertionError("GPU slice disagrees with the CPU slice")

    o_pl, s_pl = planted_embeddings(np.random.default_rng(3), 1024, 4, 64, 16, 64)
    r_fused = FovGalleryEvaluator(use_fused=True, device=device).ranks(o_pl, s_pl)
    r_fft = FovGalleryEvaluator(use_fused=False, device=device).ranks(o_pl, s_pl)
    if not np.array_equal(r_fused, r_fft):
        raise AssertionError(f"fused and FFT ranks differ on {int((r_fused != r_fft).sum())} queries")
    log(f"    planted [1024, 4, 64, 16]: fused == FFT ranks (mean rank {r_fused.mean():.4f})")

    # 6. timing (CUDA events, warm, median of >= 5)
    log(f"[6] timing on {card}")
    o, s = inputs["main path"]
    main_fns = {"plain": lambda: fused_match.fused_chord_distance_plain(o, s),
                "kernel": lambda: fused_match.fused_chord_distance_nhwc(o, s)}
    t_host, t_host_plain = interleaved_ms(main_fns["plain"], main_fns["kernel"], calls=20, reps=7)
    # At this size the wrapper's dozen launches take longer on the host than
    # its work on the card: its device time comes from CUDA graphs of 64
    # calls, kernel and plain in turns.
    graphs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        graphs[name].append(graph_ms(main_fns[name]))
    t_dev, t_dev_plain = (statistics.median(graphs[k]) for k in ("kernel", "plain"))

    def match_bounds(g, q, h, w, c, sw):
        """(f32 CUDA-core bound, 3xTF32 tensor-core bound), each (ms, by)."""
        flop = 2.0 * g * q * w * sw * h * c
        nbytes = 4.0 * (g * h * w * c + q * h * sw * c + g * w) + 8.0 * g * q
        return bound(flop, nbytes, PEAK_F32_PER_MS), bound(3 * flop, nbytes, PEAK_TF32_PER_MS)

    f32_bound, match_bound = match_bounds(*shapes["main path"])
    log(f"    main path G=Q=128 sw=64: kernel {t_host:.4f} ms, plain {t_host_plain:.4f} ms "
        f"(host-launched); device time (CUDA graphs) kernel {t_dev:.4f} ms, plain {t_dev_plain:.4f} ms; "
        f"bound {match_bound[0]:.4f} ms ({match_bound[1]}, 3xTF32 on the tensor cores at "
        f"494.7 TFLOP/s), f32 CUDA-core bound {f32_bound[0]:.4f} ms ({f32_bound[1]}) ({card})")
    o, s = inputs["gallery block"]
    t_gal, t_gal_plain = interleaved_ms(
        lambda: fused_match.fused_chord_distance_plain(o, s),
        lambda: fused_match.fused_chord_distance_nhwc(o, s), calls=3, reps=7)
    f32_gal, tf32_gal = match_bounds(*shapes["gallery block"])
    log(f"    gallery block G=8832 Q=128 sw=64: kernel {t_gal:.4f} ms, plain {t_gal_plain:.4f} ms, "
        f"bound {tf32_gal[0]:.4f} ms (3xTF32), f32 CUDA-core bound {f32_gal[0]:.4f} ms ({card})")
    wide = (128, 128, 4, 2048, 4, 64)  # 32 passes, a window of the maps refilled for each
    o, s = maps(gen, *wide, device)
    t_wide, t_wide_plain = interleaved_ms(
        lambda: fused_match.fused_chord_distance_plain(o, s),
        lambda: fused_match.fused_chord_distance_nhwc(o, s), calls=5, reps=5)
    _, tf32_wide = match_bounds(*wide)
    log(f"    W=2048 sw=64 hc=16 G=Q=128 (windows of {fused_match.geometry(128, 128, 2048, 16, 64)['kcols']} "
        f"columns): kernel {t_wide:.4f} ms, plain {t_wide_plain:.4f} ms, bound {tf32_wide[0]:.4f} ms "
        f"(3xTF32) ({card})")
    del inputs, o, s

    # The gallery rank sweep, 8832 planted pairs (host clock around ranks(),
    # which ends on the host; the second of two runs of each path).
    o_pl, s_pl = planted_embeddings(np.random.default_rng(4), 8832, 4, 64, 16, 64)
    o_pl = torch.from_numpy(o_pl).to(device)
    s_pl = torch.from_numpy(s_pl).to(device)
    sweep = {}
    for name, fused in (("fused", True), ("FFT", False)):
        evaluator = FovGalleryEvaluator(use_fused=fused, device=device)
        evaluator.ranks(o_pl, s_pl)
        t0 = time.perf_counter()
        sweep[name] = (evaluator.ranks(o_pl, s_pl), time.perf_counter() - t0)
    if not np.array_equal(sweep["fused"][0], sweep["FFT"][0]):
        raise AssertionError(f"8832-pair sweep: fused and FFT ranks differ on "
                             f"{int((sweep['fused'][0] != sweep['FFT'][0]).sum())} queries")
    log(f"    gallery sweep, 8832 planted pairs [8832, 4, 64, 16] (query block 128, gallery chunk "
        f"1024): fused {sweep['fused'][1]:.4f} s, FFT {sweep['FFT'][1]:.4f} s, ranks equal "
        f"(mean rank {sweep['fused'][0].mean():.4f}) ({card})")
    del o_pl, s_pl, sweep

    gen_in = torch.Generator(device=device).manual_seed(1)
    d = cfg.data
    staged = [
        {"surface": torch.rand(128, d.surface_height, d.surface_width_max, 3,
                               generator=gen_in, device=device) * 255.0,
         "overhead": torch.rand(128, d.overhead_size, d.overhead_size, 3,
                                generator=gen_in, device=device) * 255.0}
        for _ in range(4)
    ]
    steps = 8
    step_of = iter(range(10**9))

    def stage(fn):
        return lambda: fn(params, staged[next(step_of) % len(staged)])

    t_pre = cuda_ms(stage(lambda p, b: pipeline.preprocess(b)), steps, 5)
    t_embed = cuda_ms(stage(pipeline.embed_step), steps, 5)
    t_fwd = cuda_ms(stage(pipeline.forward_distance), steps, 5)
    pairs_per_s = 128 * 1000.0 / t_fwd
    log(f"    embed+match bf16 batch 128 (fov 360, varied inputs, convs on conv3x3_bf16): "
        f"{t_fwd:.3f} ms/step, {pairs_per_s:.2f} pairs/s (2833.07 with cuDNN convs on an H100 "
        f"80GB HBM3 at 700 W before this kernel); preprocess {t_pre:.3f} ms, embed (incl. "
        f"preprocess) {t_embed:.3f} ms, match {t_fwd - t_embed:.3f} ms ({card})")
    del staged

    int8_records = int8_phases(card, device, cfg, pipeline, params, built)
    conv_record, staged_train_rate = conv_phases(card, device, cfg, built)
    probe_records = probe_phases(card, device, built)

    cfg_witw = fov_experiment("witw", 70)
    indexes, serve_params, build_launches = phase_build_index(card, device, cfg_witw)
    phase_gallery_index(card, device)
    daemon_launches = phase_daemon(card, device, cfg_witw, indexes, serve_params)
    sweep_launches = phase_heatmap(card, device)
    cli_launches = phase_cli(card, device, staged_train_rate)
    safa_runs = [phase_safa_towers(card, device)]
    safa_runs.append(phase_safa_serving(card, device, str(SERVE_DIR / "data" / "pairs.csv")))
    safa_runs.append(phase_safa_cli(card, device))
    safa = {n: sum(c.get(n, 0) for run in safa_runs for c in run.values())
            for n in ("conv3x3", "fused_match", *INT8_MODULES)}
    log(f"    SAFA-path launches ([23] towers, [24] serving, [25] CLI): {safa}")
    if safa["fused_match"]:
        raise AssertionError("the SAFA path launched the fused match")
    base_pipeline, base_params, _ = phase_baseline_towers(card, device)
    base_towers, _ = phase_baseline_int8(card, device, base_pipeline, base_params)
    phase_baseline_profile(card, device, base_pipeline, base_params, base_towers)
    del base_pipeline, base_params, base_towers
    torch.cuda.empty_cache()
    phase_baseline_serving(card, device, str(SERVE_DIR / "data" / "pairs.csv"))
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    log(f"    baseline-path launches of the port's kernels ([26]-[28]): "
        f"{dict(BASELINE_LAUNCHES) or 'none'}")
    dynamic, dynamic_pairs_per_s, convert_launches = phase_remainder(card, device)
    sharded = phase_sharded(card, device, indexes, serve_params)
    dp_launches = phase_dp(card, device)
    parity_launches = phase_dataset(card, device)
    serving = {n: build_launches[p].get(n, 0) + daemon_launches[p].get(n, 0)
               + sweep_launches[p].get(n, 0)
               for p in ("bf16", "int8") for n in build_launches[p]}
    log(f"    serving-path launches (index builds, daemons, heatmap sweeps): {serving}; "
        f"the sweeps' alone {sweep_launches}")
    conv_record["serving_launches"] = serving["conv3x3"]
    for record, mod in zip(int8_records, INT8_KERNELS):
        record["serving_launches"] = serving[mod]
    conv_record["cli_launches"] = sum(r["conv3x3"] for r in cli_launches.values())
    conv_record["safa_launches"] = safa["conv3x3"]
    for record, mod in zip(int8_records, INT8_KERNELS):
        record["safa_launches"] = safa[mod]
    match_cli_launches = sum(r["fused_match"] for r in cli_launches.values())
    conv_record["baseline_launches"] = BASELINE_LAUNCHES["conv3x3"]
    for record, mod in zip(int8_records, INT8_KERNELS):
        record["baseline_launches"] = BASELINE_LAUNCHES[mod]
    for record, rec in zip(probe_records, PROBE_KERNELS):
        record["baseline_launches"] = BASELINE_LAUNCHES[rec]
    conv_record["convert_launches"] = convert_launches
    for record, mod in zip(int8_records, INT8_KERNELS):
        if mod == "int8_conv":
            record["dynamic_launches"] = dynamic["int8_conv"]
            record["dynamic_pairs_per_s"] = dynamic_pairs_per_s
        record["sharded_launches"] = sharded[mod]
    conv_record["sharded_launches"] = sharded["conv3x3"]
    conv_record["dp_launches"] = dp_launches["conv3x3"]
    conv_record["parity_launches"] = parity_launches["conv3x3"]

    log(card)
    log(json.dumps({"kernels": [{
        "name": "fused_corr_distance",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": t_host,
        "plain_ms": t_host_plain,
        "device_ms": t_dev,
        "plain_device_ms": t_dev_plain,
        "bound_ms": match_bound[0],
        "bound_by": match_bound[1],
        "library_ms": None,
        "cli_launches": match_cli_launches,
        "safa_launches": safa["fused_match"],
        "baseline_launches": BASELINE_LAUNCHES["fused_match"],
        "dynamic_launches": dynamic["fused_match"],
        "sharded_launches": sharded["fused_match"],
        "dp_launches": dp_launches["fused_match"],
        "parity_launches": parity_launches["fused_match"],
    }] + int8_records + [conv_record] + probe_records}))
    log(f"smoke total: {time.perf_counter() - T_START:.2f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--dp-worker":
        sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
