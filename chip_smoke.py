#!/usr/bin/env python3
"""Drive the PyTorch port's GIMM-VFI-R 8x paths (720p, and 2K/4K through
DS_SCALE and the windowed correlation), its GIMM-VFI-F 8x path at 720p,
its bench entry, its two probe entry points, its serving entry points
(stage-1 GIMM, the video CLI, the four benchmark harnesses), stage-1 GIMM
training and stage-2 GIMM-VFI training (each recipe's step and the train
CLI), data-parallel training (the step under a process group, two ranks
against one process, the CLI under torchrun) and spatial sharding (one
pair's flow estimator and decode split by width over two ranks, R and F)
once on one CUDA card;
the windowed correlation lookup's backward kernel held to its plain
version, and stage-2 training's recipe step on the windowed route; the
pipeline FLOP count at every path, and both training recipes through the
training-throughput tool; both recipes with remat and without it, and
stage-2 training at a crop whose AMT correlation goes windowed.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):
  1. the card: CUDA must be present; prints nvidia-smi's name and power limit;
  2. builds the CUDA sources of gimmvfi_tpu_torch/csrc/ (softsplat_sorted.cu,
     softsplat.cu, softsplat_bwd.cu, windowed_corr_mma.cu, windowed_corr_tf32.cu, windowed_corr.cu,
     windowed_corr_bwd.cu, conv3x3.cu, gather_probe.cu) all at once, one nvcc each; counts the
     HMMA (tensor-core) instructions in the SASS of windowed_corr_mma,
     windowed_corr_tf32 and windowed_corr_bwd (`cuobjdump -sass`) and fails
     on none; prints the
     shared memory a block and the blocks an SM of windowed_corr_tf32 at
     C = 256, from its library;
  3. the atomic splat kernel (`csrc/softsplat.cu`, on no route) against its
     plain PyTorch version on the card, float32,
     in every case of `tools/splat_ablate.py: CHECK_CASES` (the main path's
     (1,736,1280,17) on a random, a smooth and a non-finite/far flow field;
     C in {1, 3, 5, 17, 33, 64}; N = 2; value counts off a multiple of 4);
     times it at 720p on the random and the smooth field, beside its
     PyTorch yardstick (`aten.grid_sampler_2d_backward`'s input gradient
     on NCHW views, `tools/splat_ablate.py: library_calls`), held to the
     plain version first (1e-4 x max(1, max|plain|)); then the
     deterministic splat (`csrc/softsplat_sorted.cu`, the route of every
     path: keys, `torch.sort`, one tile-staged gather) in the same cases
     (one of them a collisions field whose key run is longer than a gather
     block stages at once) and at stage-1 training's (32,256,256,17): the
     same bound, two calls bitwise equal and bitwise equal to its order in
     plain torch (`splat_sum_sorted_plain`), asserted; its capacity at
     C = 17 from its library, held to `splat_ablate.sorted_capacity`; its
     whole call and its own rows (keys, sort, gather) timed at 720p on
     both fields and at (32,256,256,17) beside the atomic kernel, the
     yardstick and the bound; the route's rule (its whole call at or
     below the atomic call, device time, at 720p) printed;
  4. GIMMVFI_R(raft_iters=2) float32 at 128x192 on the card (kernel) against
     the CPU (plain core), same seeded weights, TF32 off: PSNR >= 50 dB; then
     the constructor options off JAX's defaults (`R_OPTIONS`: num_flows 2,
     the softmax splat, AMT lookups of radius 3, coord_range (-0.5, 0.5))
     the same way, materialized and at `corr_max_volume_bytes=0` (8
     radius-3 launches of the 3xTF32 kernel), each >= 50 dB, the launch
     counts printed; GIMMVFI_R(2, corr_radius=6, corr_max_volume_bytes=0)
     in float32 and in bf16 the same way (RAFT's 2 lookups on the routed
     kernel's fast case, the AMT's 6 on its general case, exactly), each
     >= 50 dB; RAFT(iters=2, corr_levels=5, corr_radius=5,
     corr_max_volume_bytes=0) float32 at 256x256, both directions' flows
     GPU vs CPU within 1e-4 of the largest (4 general launches: two groups
     of levels a lookup);
  5. the main path: GIMMVFI_R(raft_iters=20, dtype=bfloat16) on a seeded
     736x1280 pair, 7 timesteps through interpolate_sequential; checks shape,
     finiteness, range, exactly 14 sorted-splat launches, none of the atomic
     splat and no windowed-correlation
     launch (the 720p volumes fit under the 2 GiB limit); prints fps, stage ms
     and peak memory from CUDA events after one warm-up; then reads the
     splat where it runs: its own kernels' device time in a trace of one
     decode_one, and its call timed alone on the two inputs that decode_one
     gave it, beside the atomic kernel's;
  6. the probes: the conv kernel against its plain version at the probe
     shape (1,736,1280,256) and six ragged shapes, each gather kernel
     against its plain version at its probe shape and with out-of-range
     indices, subgather also on three ragged tables; then the two probe entry points, `conv_proto.main` (kernel,
     cuDNN NCHW, cuDNN channels-last, plain, bound) and
     `gather_cost_probe.main` (torch.gather / torch.sort table, kernels),
     each of whose kernels must launch; then the launch floor, the device
     time of an empty kernel, and each gather against max(floor, bound);
  7. the windowed lookup's kernels against the plain version on the card,
     each through the route (`ops/corr.py: windowed_corr_kernel_for`: bf16
     to the tensor-core `windowed_corr_mma.cu`, float32 to the 3xTF32
     tensor-core `windowed_corr_tf32.cu`; `tools/windowed_ablate.py:
     windowed_agreement`: float32 <= 1e-5 of the largest value, bf16 within
     one bf16 step, NaN at the same places), in `WINDOWED_CASES`,
     `MMA_CASES` and `TF32_CASES` (C = 256 and small C, C = 200, an odd
     level size, in-frame, smooth, border and far or non-finite
     coordinates, each float32 case also in bf16; `RADIUS3_CASES`, radius 3
     in both dtypes), at the shapes the
     2048x1088 DS 1.0 path gives it (RAFT's (2,136,256) and the AMT's
     (1,136,256), C = 256, bf16), the 720p F path's AMT shape (1,92,160)
     and the float32 720p R path's RAFT shape (2,92,160), both C = 256,
     float32, on in-frame and smooth coordinates; the kernels' general
     case (a radius past 4 or more than 4 levels: tap tiles, a launch a
     group of at most 4 levels) in `BIG_WINDOW_CASES` ((r, L) = (5, 4),
     (8, 4), (4, 5), (4, 6), (6, 5), each in both dtypes, in-frame, border
     and far or non-finite coordinates, every level at least 2 px a side)
     through the route and called directly, against the plain version under
     the same bounds, the general launches counted (`check_big_windows`);
     the float32 lookup against the materialized `corr_lookup` at the 720p
     fmap (92x160, C = 256, <= 1e-4); the CUDA-core `windowed_corr.cu`,
     called directly, on the float32 cases of `WINDOWED_CASES`; then the
     bf16 kernel and the CUDA-core one, each checked on the inputs first,
     timed in bf16 in the same run, against the bound, with
     the tile walk's union extent (`mma_tile_extents`): at the 2048x1088
     DS 1.0 RAFT lookup on in-frame and smooth coordinates (in-frame beside
     the library composition: the volume formed from the same maps under
     a raised limit, pooled and sampled, `library_lookup_reading`), at
     720p beside the materialized lookup, and (after phase 8 (c)) on the inputs of the
     first and last RAFT lookups of a `prepare` of that path, captured;
     then the backward (`csrc/windowed_corr_bwd.cu`, `WindowedCorrLookup`'s)
     against `windowed_corr_lookup_backward_plain` in the same cases and
     `WINDOWED_BWD_CASES` (radius 0 and 2, 3 levels) and `RADIUS3_BWD_CASES`
     (radius 3 in both dtypes; `windowed_bwd_agreement`:
     float32 d_f1 and d_levels <= 1e-5 x max(1, max|plain|), d_coords <=
     1e-4 x max(1, max|plain|), bf16 within one bf16 step, NaN at the same
     places), with d_coords and without, two calls of each with bitwise
     equal d_levels (asserted), and the route in each case:
     torch.autograd.grad of a seeded weighted sum of `windowed_corr_lookup`'s
     output on CUDA tensors against that of the plain lookup on the same
     tensors (one forward and one backward launch), the coordinates needing
     grad and not, under the same bounds; then its readings (`bwd_reading`:
     d_levels bitwise equal over two calls, asserted; events and device
     time of the whole call and of its parts (query side, order, destination
     side, chunk sum) against the bound, with d_coords and without, the
     forward's and the plain version's times) at (b) the 720p F AMT lookup
     (1,92,160) float32, and (c) the 2048x1088 DS 1.0 RAFT lookup
     (2,136,256) bf16, each beside the yardstick (the materialized lookup's
     autograd backward, its volume formed under a raised limit); (a) is
     phase 12 (e)'s; the backward's general case in `BIG_WINDOW_CASES`
     the same way (with d_coords and without, two calls with bitwise equal
     d_levels, the route's autograd against the plain lookup's;
     `check_big_windows_backward`); then readings at radius 8 and at 6
     levels beside radius 4 in the same run: the bf16 kernel at (c)'s
     shape and the 3xTF32 kernel at (b)'s, each held to the plain version
     (in row chunks) and beside the library composition at the same radius
     and levels (`window_readings`), and the backward at (a)'s shape (4,
     28, 28) (radius 4 and 8), (b) and (c) (`bwd_window_readings`; at (c)
     not held to the plain version, whose gathered windows would take tens
     of GB);
  8. three more main paths, each 8x bf16 with 7 timesteps and counts from 0:
     (a) 2048x1088 at DS 0.5, (b) 4096x2176 at DS 0.25, both materialized at
     1024x544, and (c) 2048x1088 at DS 1.0, windowed in RAFT and the AMT;
     checks shapes, finiteness, range, 14 splat launches and exactly 0, 0
     and 20 + 2 x 7 launches of the bf16 tensor-core windowed kernel, and
     none of the float32 or the CUDA-core one; prints fps, the
     prepare/decode_one split and peak memory (beside the reference's V100
     envelopes for (a) and (b)); then GPU vs CPU float32 >= 50 dB with the
     windowed path forced at 128x192 (float32 lookups: the 3xTF32 kernel,
     8 launches counted from 0) and with DS 0.5 at 256x384; (d)
     GIMMVFI_R(raft_iters=20, dtype=bfloat16, corr_radius=6) at 2048x1088
     DS 1.0 on (c)'s pair, 7 timesteps: exactly 20 launches of the bf16
     kernel's fast case (RAFT) and 14 of its general case (the AMT at
     radius 6), fps, the split and the peak;
  9. GIMM-VFI-F: (a) GIMMVFI_F(ff_iters=32, dtype=bfloat16) on the seeded
     736x1280 pair, 7 timesteps, through `drive_path`: shape, finiteness,
     range, exactly 14 splat, 14 `windowed_corr_tf32`, 0 `windowed_corr`
     and 0 `windowed_corr_mma` launches (FlowFormer's float32 feature map
     gives a 2.31 GB volume, over the limit, so the AMT takes the float32
     windowed route); fps, split, peak and FlowFormer alone beside the
     card's name and power limit; then, on the captured inputs of one AMT
     lookup of that path, the routed 3xTF32 kernel and the CUDA-core
     kernel against the plain version (<= 1e-5 max|plain|) and the
     3xTF32 kernel against the materialized `corr_lookup` over a pyramid
     of the same maps (<= 1e-4 max); the two kernels and that materialized
     lookup timed in the same run by events and device time, each kernel
     against its own bound (the 3xTF32 kernel: its bytes, or three TF32
     products a float32 one at the TF32 tensor-core peak; the CUDA-core
     kernel: float32 operations at the CUDA-core peak), and the library
     composition on the same lookup;
     (b) `gimmvfi_tpu_torch.bench.main` for `--model r` and `--model f` at
     736x1280 in this process, each printing one JSON line with its label
     and the JAX bench's four FLOP fields (`pipeline_tflops`,
     `v100_speed_of_light_fps`, `vs_baseline`, `baseline_is_flop_bound`)
     and the count, after a line with the achieved TFLOP/s;
     the R run with `--trace-dir build/chip_smoke_phase9`: the trace it
     names holds one `prepare` and 7 `decode_one` spans and 14 device rows
     of the sorted splat's gather (where the card's profiler records
     device activity);
     (c) GIMMVFI_F(ff_iters=2) float32 at 128x192, GPU vs CPU >= 50 dB, at
     the default limit and at `corr_max_volume_bytes=0` (exactly 2 x 3
     3xTF32 launches: only the AMT goes windowed);
 10. the serving entry points, float32 (TF32 off), in build/chip_smoke_phase10/:
     (a) stage-1 GIMM at full width with seeded weights on seeded smooth
     flows at Vimeo's 256x448: one `forward` at t = 0.5 (exactly 2 splat
     launches) and one `forward_multi` over VSF's five timesteps (10), each
     by CUDA events after a warm-up, GPU vs CPU >= 50 dB on the normalized
     flow; (b) the video CLI, `cli.video_nx.main`, on three seeded 720x1280
     PPM frames, 8x, with a seeded GIMMVFI_R(raft_iters=20) saved as a
     reference checkpoint (`state_dict` wrapper, `module.` prefixes,
     `g_filter`, `num_batches_tracked`): 2 pairs, 17 frames written (mp4 or
     PPM), exactly 28 splat launches and 2 x 34 float32 windowed lookups
     (the 720p float32 volumes, 2 x 1.16 GB, are over the 2 GiB limit, so
     RAFT's 20 lookups and the AMT's 2 a timestep are windowed), none of
     the other two; ms a pair, the whole CLI's seconds and the peak; then,
     on a model loaded from the same checkpoint, `interpolate_pair` on the
     first pair against `interpolate_sequential` on inputs padded here
     (<= 1e-5 max-abs: two runs differ by the order of the splat's float
     atomics, up to 4.1e-6 measured), the CLI's frames of that pair against
     the latter's quantized (<= 1 level), and the inputs of the pair's
     first RAFT lookup (2,92,160) and first AMT lookup (1,92,160),
     captured, held against the plain version; (c)
     the four harnesses through `cli.benchmarks.main` on fabricated data:
     SNU-FILM-arb medium (one row of five 720x1280 frames) and X4K 2k (one
     scene of 33 4096x2160 frames, links to three: 7 items at DS 0.5), both
     with a seeded LPIPS checkpoint; VTF and VSF on seeded 256x448 `.flo`
     files with a seeded GIMM checkpoint; each JSON result finite, exact
     launch counts, each harness's seconds;
 11. stage-1 GIMM training, float32 (TF32 off), in build/chip_smoke_phase11/;
     every GIMM trained here (and in 13, 15 (c)) has remat on, as the
     train CLI builds it; every stage-2 model of 12, 13 and 15 (c) too, its
     default:
     (a) the splat's backward kernel (`csrc/softsplat_bwd.cu`) against
     `splat_sum_backward_plain` in `tools/splat_ablate.py: BWD_CASES` (the
     recipe step's (32, 256, 256, 17) on a random, a smooth and a
     non-finite/far field, the small `CHECK_CASES`, C = 130, 34 and 16,
     widths off its 32-column tile; d_vals and d_flow <= 1e-5 x max(1,
     max|plain|); d_vals without d_flow equal); two calls bitwise equal in
     both modes on the random and the non-finite field; both modes timed
     by events and device rows against each mode's bound, beside the plain
     version, the forward kernel at that shape and the PyTorch yardsticks
     (`F.grid_sample` for d_vals, `aten.grid_sampler_2d_backward`'s grid
     gradient for d_flow, the forward's too), each held to the plain
     version first;
     (b) the recipe's step (`configs/gimm/gimm.yaml`: GIMM, Adam lr 1e-4,
     batch 32, 256^2) on seeded smooth flows: one step counted from 0
     (exactly 2 forward and 2 backward splat launches, no windowed one), 10
     timed after 3 warm-ups (median ms, peak, finite loss, parameters
     moved), and the device time of one step and its splats in a trace;
     (c) one step at 64x64, batch 2, GPU vs CPU from the same seeded
     weights and batch, 3 seeds and 2 runs on the card each: loss <= 1e-5
     relative, each gradient <= 1e-4 x max|g_cpu|; the scalar `alpha_v`
     and `alpha_fe`, whose gradients are near-cancelling sums over pixels,
     <= 1e-4 x the sum of their terms' magnitudes, with the fields they
     contract held to 1e-4 x max (every reading printed); (d) `cli.train.main` with the recipe's config and
     `--smoke-test` on a fabricated tree of 256x448 `.flo` triplets: one
     epoch of 2 steps with validation and a checkpoint, then `--resume` for
     a second, exact launches, steps, seconds an epoch, the PyYAML version
     and whether tensorboardX was found;
 12. stage-2 GIMM-VFI training, float32 (TF32 off), in build/chip_smoke_phase12/:
     (a) the recipe's step (`configs/gimmvfi/gimmvfi_r_arb.yaml`:
     GIMMVFI_R(raft_iters=20) from a seed, AdamW lr 8e-5 with the ft
     groups, EMA, the perceptual loss from a seeded LPIPS, batch 4 at
     224^2, t = k/6) on a seeded smooth batch: one step counted from 0
     (exactly 6 forward and 6 backward splat launches, no windowed one), 10
     timed after 2 warm-ups (median ms, peak, finite loss and LPIPS term;
     both groups' parameters, the BatchNorm running statistics and the EMA
     moved), the device time of one step and its splats in a trace;
     (b) one step of GIMMVFI_R(raft_iters=2) at 128x128, batch 2, GPU vs
     CPU from the same seeded weights and batch, 2 seeds: loss <= 1e-5
     relative, running statistics <= 1e-5 x max(1, max|cpu|), gradients as
     ROADMAP C3 holds stage 2's (each tensor within 1e-2 relative L2; the
     biases that feed a normalization within 1e-2 x max|g| of their
     weights; the alphas within 1e-4 x S); (c) `cli.train.main` with that
     config and `--smoke-test` on a fabricated tree of 8 septuplets of
     256x448 PNGs written with cv2, `--load-path` phase 11's stage-1
     checkpoint, `--lpips-path` a seeded LPIPS `.pt`: one epoch of 2 steps
     with validation, the grid and a checkpoint, then `--resume` for a
     second; exact launches, seconds an epoch and whether Pillow was found;
     (d) one recipe step of GIMMVFI_F() (`gimmvfi_f_arb.yaml`, the same
     LPIPS): exact launches counted from 0, 3 timed after 2 warm-ups (median
     ms, peak), no trace; (e) (a)'s step with `corr_max_volume_bytes=0`:
     exact launches counted from 0 (42 float32 lookups, RAFT's 2 x 20 and
     the AMT's 2, and 42 backward launches; no bf16 or CUDA-core one), a
     finite loss, the events median beside (a)'s, the peak, the device
     time of one traced step, of its lookups and of its backwards' own
     kernels; the backward's readings (a) on the step's AMT lookup,
     captured, beside the yardstick;
     then from the same seeded weights and batch the windowed step's
     gradients against the default (materialized) step's on the card,
     under (b)'s bounds; (f) (b)'s step with
     GIMMVFI_R(raft_iters=2, corr_radius=5, corr_max_volume_bytes=0), GPU
     vs CPU under (b)'s bounds, exact launches (RAFT's 4 lookups and their
     backwards on the fast cases, the AMT's 2 and theirs on the general
     cases);
 13. data-parallel training (`parallel/dist.py`), float32, in
     build/chip_smoke_phase13/: (a) phase 12 (a)'s recipe step through the
     data-parallel step under a process group of one NCCL rank on the card
     (the gradient's flat all-reduce and the metrics' mean run): exact
     launches (6 + 6), the events median of 10 after 2 warm-ups beside
     phase 12 (a)'s, the peak, the device time of one traced step with its
     NCCL rows named; (b) two gloo ranks on the card (`spawn_ranks`; NCCL
     refuses two ranks on one device) at batch 1 each against one process
     at batch 2 on the card, from the same seeded weights and batch: phase
     11 (c)'s stage-1 step (GIMM at 64x64) and phase 12 (b)'s stage-2 step
     (GIMMVFI_R(raft_iters=2) at 128x128, BatchNorm's statistics across
     the ranks), held to those phases' bounds, the ranks' parameters and
     buffers after the step bitwise equal; (c) phase 12 (c)'s first epoch
     as `torchrun --standalone --nproc_per_node 1 -m
     gimmvfi_tpu_torch.cli.train` on the same tree, run beside (b): exit 0,
     its epoch-0 metrics (`metrics.jsonl`) within 1e-4 relative of phase
     12 (c)'s;
 14. spatial sharding (`parallel/spatial.py: interpolate_spatial_sharded`)
     in build/chip_smoke_phase14/: two gloo ranks on the card
     (`spawn_ranks`, `spatial.interpolate_on_rank`; rank 1 builds its model
     from another seed and takes rank 0's weights through the entry's
     broadcast), each case against `interpolate_sequential` in this
     process on the same seeded weights and pair, 7 timesteps: (a)
     GIMMVFI_R(raft_iters=20, dtype=bfloat16) at 2048x1088 DS 1.0, >= 50
     dB, exactly 14 splat and 34 `windowed_corr_mma` launches a rank (RAFT's
     20 on each rank's query strip: `prepare_sharded` runs RAFT on a strip
     a rank; no windowed backward launch on any path); (b)
     the same at 4096x2176 DS 0.25, >= 50 dB, 14 and 0; (c)
     GIMMVFI_R(raft_iters=2) float32 at 256x512, <= 1e-5 max-abs, 14 and
     0, one process against itself printed; (d) GIMMVFI_F(ff_iters=32,
     dtype=bfloat16) at 736x1280, FlowFormer's query map sharded
     (`FlowFormer.forward_sharded`), >= 50 dB, exactly 14 splat and 14
     `windowed_corr_tf32` launches a rank (the AMT's, whole on every rank)
     and none of the others; the ranks' results bitwise
     equal, the flow estimator's route, the peak a rank beside the single process's,
     each call's seconds and a `prepare_sharded`'s beside one process's
     `prepare` (two ranks share the card: no speed figure);
 15. the pipeline FLOP count (`bench.count_flops`: matmul and conv
     products, a windowed lookup charged `windowed_corr_work`'s dots):
     (a) on the card and on the CPU, equal op by op, for
     GIMMVFI_R(raft_iters=2) float32 at 128x192 and GIMMVFI_F(ff_iters=2)
     at 128x128, 3 timesteps, materialized and at
     `corr_max_volume_bytes=0` (8 and 6 `windowed_corr_tf32` launches on
     the card); (b) at every path of phases 5, 8 and 9 (a), each counted
     once more from the same seed and pair with the timed run's launches,
     and the achieved TFLOP/s at that phase's fps; 720p R's count equal to
     the bench's; (c) `tools.train_throughput.main` at 20 steps a stage
     (stage 1: GIMM, batch 32 at 256x256; stage 2: GIMMVFI_R(raft_iters=20),
     batch 4 at 224x224, no perceptual loss): its record printed last,
     finite losses, exactly 160 forward and 160 backward splat launches;
 16. remat (activation recomputation), float32 (TF32 off), in
     build/chip_smoke_phase16/: (a) each recipe's step (stage 1: GIMM,
     batch 32 at 256x256; stage 2: GIMMVFI_R(raft_iters=20) and
     GIMMVFI_F(), batch 4 at 224x224, a seeded LPIPS) from one seed and
     batch with remat off, on, and off again: each first step counted from
     0 (exact splat launches, no windowed one: no recompute launches a
     kernel again) with its peak allocated, 2 more timed by events (median
     ms a step); the loss and the BatchNorm running statistics bitwise
     between the modes; each gradient within 1e-5 x max(1, max|g|), the
     tensors bitwise under remat and between the two steps without it
     counted, with each one's largest gap (the backward adds with atomics
     in `grid_sample`: two steps agree bitwise only by chance); remat's
     peak below; (b)
     one recipe step of GIMMVFI_R(raft_iters=20) with remat at batch 1,
     960x960 (`TRIGGER`; batch 4 at 704x704 and batch 2 at 832x832, the
     other crops where the AMT goes windowed and RAFT does not, run out of
     memory): the AMT's bidirectional volume passes the 2 GiB limit,
     RAFT's stays materialized; exact launches (the AMT's 2
     `windowed_corr_tf32` lookups and their 2 backwards on the fast cases,
     6 + 6 splats), 2 steps timed after the counted one, the peak, finite
     losses, the 2 windowed backward calls of the last step by CUDA
     events (the host waiting for the card before each), the step without
     remat reckoned from (a)'s peak by pixels.
Phase 2 prints ptxas's registers, spills and warnings for each source and
whether it serialised `wgmma.mma_async`. Phases 3 and 6 time each kernel
with CUDA events around each call (`ms`) and also read its own device time
from a `torch.profiler` trace (`device_ms`; for the probes' library calls
`library_device_ms`; the conv and cuDNN are traced in turns). Where the
profiler records no device activity, those readings are null and print as
"not measured"; the events' times, the checks and the counts stand. The launch
counts are set to 0 just before each path (5, the probes of 6, each path
of 8, 9 (a), each GPU-vs-CPU run, each path of 10, the counted step
and each CLI call of 11 and of 12, the counted step of 13 (a), each
case of 14 in this process and on each rank, each counted call of 15 and
its training tool's run) and read just after it;
the general cases' records carry the launches of their own paths (the
bf16 one phase 8 (d)'s, the 3xTF32 one phase 4's radius-6 float32 path,
the backward phase 12 (f)'s) and their readings at radius 8 (their
numbers) and 6 levels beside the fast case's; the sorted splat's and the
3xTF32 kernel's records carry their phase 10 counts (`launches_phase10`)
and (the 3xTF32 kernel) each rank's phase 14 counts,
the splat backward's `launches` are those of the counted recipe step; the
sorted splat's and the backward's records carry their phase 12 and phase
13 (a) steps' counts (`launches_phase12_step`, `launches_phase13_step`);
the atomic splat's `launches` are 0 (asserted on every path); the sorted
splat's and the bf16 tensor-core lookup's records carry each rank's phase 14 counts
(`launches_phase14`); the windowed backward's `launches` are those of
phase 12 (e)'s counted step, 0 on every inference path (asserted), and the
3xTF32 kernel's record carries that step's count too
(`launches_phase12_windowed_step`); the sorted splat's, the splat
backward's, the 3xTF32 kernel's and the windowed backward's records carry
phase 16 (b)'s counts (`launches_phase16_trigger_step`), the windowed
backward's also its calls' times there (`phase16_trigger_step_bwd_ms`).
The line before the last is the kernels' JSON record; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from gimmvfi_tpu_torch import bench
from gimmvfi_tpu_torch.cli import benchmarks as bench_cli
from gimmvfi_tpu_torch.cli import video_nx
from gimmvfi_tpu_torch.data.frame_io import read_image, read_ppm, write_flo, write_ppm
from gimmvfi_tpu_torch.flow.raft import RAFT
from gimmvfi_tpu_torch.models import gimm as gimm_model
from gimmvfi_tpu_torch.models import gimmvfi_r as gimmvfi_r_model
from gimmvfi_tpu_torch.models.gimm import GIMM
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.ops import corr as corr_ops
from gimmvfi_tpu_torch.ops.corr import (
    WINDOWED_CORR_BWD_GENERAL_KERNEL,
    WINDOWED_CORR_BWD_KERNEL,
    WINDOWED_CORR_KERNEL,
    WINDOWED_CORR_MMA_GENERAL_KERNEL,
    WINDOWED_CORR_MMA_KERNEL,
    WINDOWED_CORR_TF32_GENERAL_KERNEL,
    WINDOWED_CORR_TF32_KERNEL,
    WindowedCorr,
    windowed_corr_lookup_backward_plain,
    windowed_corr_lookup_plain,
)
from gimmvfi_tpu_torch.ops import softsplat as softsplat_ops
from gimmvfi_tpu_torch.ops.pad import InputPadder
from gimmvfi_tpu_torch.parallel import dist as dist_ops
from gimmvfi_tpu_torch.parallel import spatial
from gimmvfi_tpu_torch.ops.softsplat import (
    SPLAT_BACKWARD_KERNEL,
    SPLAT_KERNEL,
    SPLAT_SORTED_KERNEL,
    splat_sum_backward_plain,
    splat_sum_plain,
    splat_sum_sorted_plain,
)
from gimmvfi_tpu_torch.tools import conv_proto, gather_ablate, gather_cost_probe, train_throughput
from gimmvfi_tpu_torch.tools.conv_proto import CONV3X3_KERNEL, conv3x3_plain
from gimmvfi_tpu_torch.tools.gather_cost_probe import GATHERS, SUBGATHER_KERNEL, subgather_plain
from gimmvfi_tpu_torch.tools.windowed_ablate import (
    AMT_2K,
    BIG_WINDOW_CASES,
    F_AMT_720P,
    MMA_CASES,
    PATH_KINDS,
    RAFT_2K,
    RAFT_720P,
    STAGE2_AMT,
    TF32_CASES,
    TF32_PRODUCTS,
    WINDOW_READINGS,
    WINDOWED_BWD_CASES,
    WINDOWED_CASES,
    bitwise_equal,
    bwd_bound,
    bwd_parts,
    extent_summary,
    f32_lookup_bounds,
    fmt_extent,
    mma_tile_extents,
    tf32_config,
    windowed_agreement,
    windowed_bwd_agreement,
    windowed_inputs,
)
from gimmvfi_tpu_torch.tools.splat_ablate import (
    BWD_CASES,
    CHECK_CASES,
    MAIN_SHAPE,
    TRAIN_SPLAT,
    TRAIN_STD,
    bwd_inputs,
    kernel_bound_ok,
    library_agreement,
    library_calls,
    sorted_capacity,
    sorted_tile,
    splat_bound,
    splat_bwd_bound,
    splat_inputs,
)
from gimmvfi_tpu_torch.cli import train as train_cli
from gimmvfi_tpu_torch.train.lpips import LPIPS
from gimmvfi_tpu_torch.train.optim import create_optimizer
from gimmvfi_tpu_torch.train.train_state import (
    create_train_state,
    make_gimm_train_step,
    make_gimmvfi_train_step,
)
from gimmvfi_tpu_torch.utils.config import load_config
from gimmvfi_tpu_torch.utils.kernel_build import CSRC, build_libraries, find_nvcc, library_path
from gimmvfi_tpu_torch.utils.timing import (
    H100_BYTES_PER_S,
    H100_TF32_FLOPS,
    bound_ms,
    cuda_ms,
    device_ms,
    fmt_ms,
    fmt_share,
    kernel_row,
    launch_floor_ms,
)

H, W = 736, 1280
N_T = 7
SEED = 0
PROBE_KERNELS = [CONV3X3_KERNEL] + [g[0] for g in GATHERS.values()]
# the windowed kernels' general cases (any radius and level count), each
# counted on its own
GENERAL_KERNELS = [WINDOWED_CORR_MMA_GENERAL_KERNEL, WINDOWED_CORR_TF32_GENERAL_KERNEL,
                   WINDOWED_CORR_BWD_GENERAL_KERNEL]
KERNELS = [SPLAT_SORTED_KERNEL, SPLAT_KERNEL, SPLAT_BACKWARD_KERNEL, WINDOWED_CORR_MMA_KERNEL,
           WINDOWED_CORR_TF32_KERNEL, WINDOWED_CORR_KERNEL, WINDOWED_CORR_BWD_KERNEL
           ] + GENERAL_KERNELS + PROBE_KERNELS
# (x shape, Cout): the probe shape, then ragged rows, tiles and channel chunks;
# then one pixel, W one over a 128-pixel tile multiple, and Cin off the
# 64-channel chunk with Cout under a 256-channel tile (the TMA zero fill)
CONV_CASES = [((1, H, W, 256), 256), ((1, 17, 23, 256), 256), ((2, 33, 40, 64), 64),
              ((1, 5, 130, 48), 80), ((1, 1, 1, 16), 16), ((2, 9, 257, 64), 256),
              ((1, 7, 200, 80), 96)]


def check_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this check needs a CUDA card")
    smi = ", ".join(bench.card_info())
    print(smi, flush=True)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return smi


def build_kernels():
    t0 = time.perf_counter()
    logs = build_libraries(Path(k.source).name for k in KERNELS)
    dt = time.perf_counter() - t0
    for k in KERNELS:
        k.build()  # loads the library just built
    for name, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines()]
        keep = ("registers", "spill", "wgmma", "setmaxnreg")
        ptxas = [ln for ln in lines if any(k in ln for k in keep) or "warning" in ln.lower()]
        serial = [ln for ln in lines if "wgmma" in ln and "serializ" in ln]
        print(f"[2] built gimmvfi_tpu_torch/csrc/{name} (nvcc, sm_90a); ptxas: {' | '.join(ptxas)}",
              flush=True)
        print(f"[2] {name}: wgmma.mma_async serialised by ptxas: "
              f"{'yes: ' + ' | '.join(serial) if serial else 'no'}", flush=True)
    print(f"[2] {len(logs)} sources built in parallel in {dt:.2f} s", flush=True)
    for kernel in (WINDOWED_CORR_MMA_KERNEL, WINDOWED_CORR_TF32_KERNEL, WINDOWED_CORR_BWD_KERNEL):
        name = Path(kernel.source).name
        sass = subprocess.run([str(Path(find_nvcc()).with_name("cuobjdump")), "-sass",
                               str(library_path(name))], capture_output=True, text=True, check=True)
        hmma = sum("HMMA" in ln for ln in sass.stdout.splitlines())
        print(f"[2] {name}: {hmma} HMMA instructions in its SASS (cuobjdump -sass)", flush=True)
        if not hmma:
            raise AssertionError(f"{name} holds no tensor-core instruction")
    name = Path(WINDOWED_CORR_TF32_KERNEL.source).name
    warps = tf32_config((CSRC / name).read_text())[0]
    lib = ctypes.CDLL(str(library_path(name)))
    print(f"[2] {name}: {lib.windowed_corr_tf32_smem_bytes(256)} B of shared memory a block, "
          f"{lib.windowed_corr_tf32_blocks_per_sm(256)} blocks of {warps} warps an SM at C=256",
          flush=True)


def splat_reading(vals, flow, label: str) -> dict:
    """Events time, device time (the kernel alone and the call with its zero
    fill) and plain time of the splat on these inputs, printed against the
    bound."""
    ms = cuda_ms(lambda: SPLAT_KERNEL(vals, flow), warmup=3)
    plain_ms = cuda_ms(lambda: splat_sum_plain(vals, flow), warmup=3)
    dev_ms, by_name = device_ms(lambda: SPLAT_KERNEL(vals, flow))
    own = kernel_row(by_name, "splat_sum_kernel")
    bound, bound_by = splat_bound(vals)
    print(f"{label}: kernel {ms:.4f} ms by events ({fmt_share(bound, ms)}), device "
          f"{fmt_ms(own)} ({fmt_share(bound, own)}), call with zero fill "
          f"{fmt_ms(dev_ms)}; plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({bound_by}) "
          f"[{'; '.join(f'{k[:60]} {v:.4f}' for k, v in by_name.items())}]", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "kernel_device_ms": own, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by}


def yardstick_readings(vals, flow, g=None, label: str = "") -> dict:
    """The PyTorch calls that compute the splat's functions (`splat_ablate:
    library_calls`), first held to the plain version on these inputs
    (1e-4 x max(1, max|plain|): the normalized-coordinate round trip), then
    each timed by events and by its device rows (all of them: the call's
    kernels and fills). Returns {name: {"ms", "device_ms", "max_abs_err",
    "tolerance", "layout"}}; the port never calls them."""
    agree = library_agreement(vals, flow, g)
    res = {}
    for name, call in library_calls(vals, flow, g).items():
        err, tol, layout = agree[name]
        ms = cuda_ms(call, warmup=3)
        dev, rows = device_ms(call)
        res[name] = {"ms": ms, "device_ms": dev, "max_abs_err": err, "tolerance": tol,
                     "layout": f"inputs NCHW views of the channels-last tensors (no copy), "
                               f"{layout}"}
        print(f"{label} yardstick {name}: {ms:.4f} ms by events, device {fmt_ms(dev)} "
              f"[{'; '.join(f'{k[:50]} {v:.4f}' for k, v in rows.items())}]; max_abs_err "
              f"{err:.3e} against the plain version (tolerance {tol:.3e}); {res[name]['layout']}",
              flush=True)
    return res


def check_kernel() -> dict:
    worst = 0.0
    for i, (shape, field, std) in enumerate(CHECK_CASES):
        vals, flow = splat_inputs(shape, field, std, seed=SEED + i)
        got = SPLAT_KERNEL(vals, flow)
        ref = splat_sum_plain(vals, flow)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok, bound = kernel_bound_ok(err, ref)
        print(f"[3] splat {shape} {field} flow std {std}: max_abs_err={err:.3e} "
              f"(bound {bound:.3e})", flush=True)
        if not ok:
            raise AssertionError(f"splat kernel disagrees with its plain version at {shape} {field}")
        worst = max(worst, err)

    stats = {"max_abs_err": worst}
    for field in ("random", "smooth"):
        vals, flow = splat_inputs(MAIN_SHAPE, field, 20.0, seed=SEED)
        label = f"[3] splat {MAIN_SHAPE} {field} flow std 20"
        reading = splat_reading(vals, flow, label)
        lib = yardstick_readings(vals, flow, label=label)["forward"]
        reading.update(library_ms=lib["ms"], library_device_ms=lib["device_ms"])
        if field == "random":
            stats.update(reading, library_call="aten.grid_sampler_2d_backward, input gradient",
                         library_layout=lib["layout"], library_max_abs_err=lib["max_abs_err"],
                         library_tolerance=lib["tolerance"])
        else:
            stats.update({f"smooth_{k}": reading[k] for k in (
                "ms", "kernel_device_ms", "plain_ms", "library_ms", "library_device_ms")})
    return stats


def sorted_rows(by_name: dict) -> float | None:
    """The sorted splat's own kernels (keys, gather) in a `device_ms`
    reading, summed; None where the trace holds none."""
    rows = [v for k, v in by_name.items() if "splat_sorted_" in k]
    return sum(rows) if rows else None


def sorted_split(by_name: dict) -> dict:
    """A `device_ms` reading of the sorted splat's call by part: its keys
    kernel, its gather kernel and the rest of the call (`torch.sort`'s
    kernels); each None where the trace holds no such row."""
    rest = [v for k, v in by_name.items() if "splat_sorted_" not in k]
    return {"keys_device_ms": kernel_row(by_name, "splat_sorted_keys"),
            "sort_device_ms": sum(rest) if rest else None,
            "gather_device_ms": kernel_row(by_name, "splat_sorted_gather")}


def sorted_reading(vals, flow, label: str) -> dict:
    """The sorted splat on these inputs: its whole call (keys, sort, gather,
    allocations) by events and by device time, its own kernels' device
    time and the call's parts (`sorted_split`), beside the atomic kernel's
    call in the same run; the plain version and the bound."""
    ms = cuda_ms(lambda: SPLAT_SORTED_KERNEL(vals, flow), warmup=3)
    dev_ms, by_name = device_ms(lambda: SPLAT_SORTED_KERNEL(vals, flow))
    own, parts = sorted_rows(by_name), sorted_split(by_name)
    atomic_ms = cuda_ms(lambda: SPLAT_KERNEL(vals, flow), warmup=3)
    atomic_dev, atomic_rows = device_ms(lambda: SPLAT_KERNEL(vals, flow))
    atomic_own = kernel_row(atomic_rows, "splat_sum_kernel")
    plain_ms = cuda_ms(lambda: splat_sum_plain(vals, flow), iters=5)
    bound, bound_by = splat_bound(vals)
    gather = parts["gather_device_ms"]
    print(f"{label}: sorted kernel's call {ms:.4f} ms by events, device {fmt_ms(dev_ms)} "
          f"({fmt_share(bound, dev_ms)}): keys {fmt_ms(parts['keys_device_ms'])}, sort "
          f"{fmt_ms(parts['sort_device_ms'])}, gather {fmt_ms(gather)} "
          f"({fmt_share(bound, gather)}); the atomic kernel's call {atomic_ms:.4f} ms by "
          f"events, device {fmt_ms(atomic_dev)}, kernel {fmt_ms(atomic_own)}; plain "
          f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({bound_by}) "
          f"[{'; '.join(f'{k[:60]} {v:.4f}' for k, v in by_name.items())}]", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "kernel_device_ms": own, **parts,
            "atomic_ms": atomic_ms, "atomic_device_ms": atomic_dev,
            "atomic_kernel_device_ms": atomic_own, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by}


def check_sorted_kernel() -> dict:
    """Phase 3, the deterministic splat (`csrc/softsplat_sorted.cu`, the
    route of every path): its capacity at C = 17 (entries a gather block
    stages at once, from its library) held to `sorted_capacity`; in every
    case of `CHECK_CASES` and at stage-1 training's `TRAIN_SPLAT`, against
    the plain version (1e-5 x max(1, max|plain|)), two calls bitwise equal
    and bitwise equal to its order in plain torch (`splat_sum_sorted_plain`);
    then timed at the main path's shape on the random and the smooth field
    and at `TRAIN_SPLAT`, each beside the atomic kernel and the yardstick,
    and the route's rule (its whole call at or below the atomic one, device
    time, at the main shape) printed."""
    name = Path(SPLAT_SORTED_KERNEL.source).name
    lib = ctypes.CDLL(str(library_path(name)))
    capacity, tile = lib.softsplat_sorted_capacity(17), sorted_tile((CSRC / name).read_text())
    print(f"[3] sorted splat: a {tile['kRows']}x{tile['kCols']} tile a gather block of "
          f"{tile['kGatherThreads']} threads, {capacity} entries staged at once at C=17, "
          f"{lib.softsplat_sorted_blocks_per_sm(17)} blocks an SM", flush=True)
    if capacity != sorted_capacity(17, tile):
        raise AssertionError(f"the sorted splat's capacity {capacity} is not "
                             f"splat_ablate.sorted_capacity's {sorted_capacity(17, tile)}")
    worst = 0.0
    for i, (shape, field, std) in enumerate(CHECK_CASES + [(TRAIN_SPLAT, "random", TRAIN_STD)]):
        vals, flow = splat_inputs(shape, field, std, seed=SEED + i)
        got = SPLAT_SORTED_KERNEL(vals, flow)
        again = SPLAT_SORTED_KERNEL(vals, flow)
        ref = splat_sum_plain(vals, flow)
        order = splat_sum_sorted_plain(vals, flow)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        gap = float((got - order).abs().max())
        ok, bound = kernel_bound_ok(err, ref)
        same, bitwise = torch.equal(got, again), torch.equal(got, order)
        print(f"[3] sorted splat {shape} {field} flow std {std}: max_abs_err={err:.3e} (bound "
              f"{bound:.3e}); two calls bitwise equal: {same}; bitwise equal to its order in "
              f"plain torch: {bitwise} ({gap:.3e})", flush=True)
        if not (ok and same and bitwise):
            raise AssertionError(f"the sorted splat at {shape} {field}: {err:.3e} off the plain "
                                 f"version, two calls equal: {same}, equal to its order in "
                                 f"plain torch: {bitwise} ({gap:.3e})")
        worst = max(worst, err)
    stats = {"max_abs_err": worst, "order_max_abs_err": 0.0, "bitwise_order": True,
             "deterministic": True, "tolerance": "1e-5 max(1, max|plain|); bitwise its order",
             "capacity_c17": capacity}
    for shape, field, std in ((MAIN_SHAPE, "random", 20.0), (MAIN_SHAPE, "smooth", 20.0),
                              (TRAIN_SPLAT, "random", TRAIN_STD)):
        vals, flow = splat_inputs(shape, field, std, seed=SEED)
        label = f"[3] sorted splat {shape} {field} flow std {std:g}"
        reading = sorted_reading(vals, flow, label)
        lib = yardstick_readings(vals, flow, label=label)["forward"]
        reading.update(library_ms=lib["ms"], library_device_ms=lib["device_ms"])
        key = ("" if shape == MAIN_SHAPE and field == "random"
               else "smooth_" if shape == MAIN_SHAPE else "train_shape_")
        stats.update({f"{key}{k}": v for k, v in reading.items()})
        del vals, flow
    dev, atomic = stats["device_ms"], stats["atomic_device_ms"]
    stats["route_rule"] = None if dev is None or atomic is None else dev <= atomic
    print(f"[3] the route's rule at {MAIN_SHAPE}, random flow: the sorted call {fmt_ms(dev)} "
          f"at or below the atomic call {fmt_ms(atomic)} (device): "
          + ("not measured" if stats["route_rule"] is None
             else "met" if stats["route_rule"] else "missed"), flush=True)
    return stats


class SplatRecorder:
    """Stands in for the splat kernel of the route in `ops.softsplat` and
    keeps a copy of each input it is given."""

    def __init__(self):
        self.inputs = []

    def __call__(self, vals, flow):
        self.inputs.append((vals.clone(), flow.clone()))
        return SPLAT_SORTED_KERNEL(vals, flow)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def check_small_e2e(phase=4, hw=(128, 192), ds_factor=None,
                    limit=corr_ops.MAX_VOLUME_BYTES, family=GIMMVFI_R, dtype=None,
                    **options) -> tuple[float, int]:
    """GPU vs CPU on one small pair, same seeded weights, of `family` with 2
    flow iterations, `dtype` (float32 when None) and the constructor
    `options`; the card's windowed lookups go to the kernel of the features'
    dtype: float32 to the 3xTF32 kernel, bf16 to the bf16 one, each on its
    general case where the AMT's radius passes 4 (RAFT's stays 4). The
    launches are counted from 0 and held exactly. Returns (PSNR, the routed
    kernel's fast-case launches)."""
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.random((1, 2, *hw, 3), dtype=np.float32))
    ts = [0.25, 0.5, 0.75]
    cpu_model = init_normal_(family(2, dtype=dtype, device="cpu", corr_max_volume_bytes=limit,
                                    **options), SEED)
    # the card, same seeded weights
    gpu_model = init_normal_(family(2, dtype=dtype, corr_max_volume_bytes=limit, **options), SEED)
    ref = interpolate_sequential(cpu_model, img, ts, ds_factor)["imgt_pred"]
    # the host frames go in as they are: prepare moves them to the card
    reset_counts()
    got = interpolate_sequential(gpu_model, img, ts, ds_factor)["imgt_pred"].cpu()
    launches = {k.name: k.launches for k in KERNELS if k is not SPLAT_SORTED_KERNEL}
    if got.shape != (len(ts), 1, *hw, 3):
        raise AssertionError(f"imgt_pred shape {tuple(got.shape)}")
    # RAFT's 2 lookups (FlowFormer's own volume is always materialized),
    # then the AMT's two a timestep
    routed = WINDOWED_CORR_MMA_KERNEL if dtype == torch.bfloat16 else WINDOWED_CORR_TF32_KERNEL
    flow_lookups = 2 if family is GIMMVFI_R else 0
    amt = corr_ops.fast_case(4, options.get("corr_radius", 4))
    want = {name: 0 for name in launches}
    if limit == 0:
        want[routed.name] = flow_lookups + (2 * len(ts) if amt else 0)
        want[routed.general.name] = 0 if amt else 2 * len(ts)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    db = psnr(got, ref)
    counted = {k: v for k, v in launches.items() if v}
    print(f"[{phase}] {family.__name__}(2{''.join(f', {k}={v}' for k, v in options.items())}) "
          f"{str(dtype or torch.float32)[6:]} {hw[0]}x{hw[1]}, ds_factor={ds_factor}, "
          f"corr_max_volume_bytes={limit}, t={ts}: GPU vs CPU PSNR {db:.2f} dB (windowed "
          f"launches on the card {counted or 'none'}; {SPLAT_SORTED_KERNEL.launches} sorted "
          f"splat)", flush=True)
    if not db >= 50.0:
        raise AssertionError(f"GPU and CPU disagree: {db:.2f} dB < 50 dB")
    return db, launches[routed.name]


def check_raft_gpu_vs_cpu(hw=(256, 256)) -> dict:
    """Phase 4: RAFT(iters=2, corr_levels=5, corr_radius=5,
    corr_max_volume_bytes=0) float32 on one seeded pair, both directions,
    on the card (every lookup on the 3xTF32 kernel's general case: two
    groups of levels, 4 and 1, so 2 launches a lookup) and on the CPU from
    the same seeded weights: every flow within 1e-4 of the largest CPU
    flow."""
    kw = {"iters": 2, "corr_levels": 5, "corr_radius": 5, "corr_max_volume_bytes": 0}
    gen = torch.Generator(device="cpu").manual_seed(SEED + 30)
    img1, img2 = (torch.rand((1, 3, *hw), generator=gen) * 255.0 for _ in range(2))
    cpu_model = init_normal_(RAFT(device="cpu", **kw), SEED)
    gpu_model = init_normal_(RAFT(**kw), SEED)
    with torch.inference_mode():
        ref = cpu_model(img1, img2)[0]
        reset_counts()
        got = gpu_model(img1.cuda(), img2.cuda())[0].cpu()
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    want = {WINDOWED_CORR_TF32_GENERAL_KERNEL.name: 2 * kw["iters"]}
    if launches != want:
        raise AssertionError(f"[4] RAFT launches {launches}, expected {want}")
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"[4] RAFT({', '.join(f'{k}={v}' for k, v in kw.items())}) f32 {hw[0]}x{hw[1]}, both "
          f"directions: GPU vs CPU flows max-abs {err:.3e} of max|flow| {scale:.3e} "
          f"({err / scale:.2e} relative; launches {launches})", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError(f"[4] RAFT GPU and CPU flows disagree: {err:.3e} > 1e-4 x {scale:.3e}")
    return {"max_abs_err": err, "scale": scale, "launches": launches}


def drive_path(model, img_xs, ts, ds_factor, windowed_expected: int, label: str,
               tf32_expected: int = 0, general_expected: int = 0):
    """One main path through `interpolate_sequential`: a warm-up, then the
    timed run with every count set to 0 just before it and read just after;
    checks the shapes, finiteness, range and launch counts (14 splats,
    `windowed_expected` of the bf16 tensor-core lookup's fast case,
    `general_expected` of its general case, `tf32_expected` of the float32
    one's fast case, none of the float32 general case, the CUDA-core one or
    a backward); then the stage split on the same inputs, CUDA events
    around `prepare` and each `decode_one`. Returns (numbers, the split
    run's prepare output)."""
    _, _, h, w, _ = img_xs.shape
    scale = ds_factor or 1
    interpolate_sequential(model, img_xs, ts, ds_factor)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    out = interpolate_sequential(model, img_xs, ts, ds_factor)
    end.record()
    end.synchronize()
    splats, wins = SPLAT_SORTED_KERNEL.launches, WINDOWED_CORR_MMA_KERNEL.launches
    tf32, cuda_core = WINDOWED_CORR_TF32_KERNEL.launches, WINDOWED_CORR_KERNEL.launches
    atomic, corr_bwd = SPLAT_KERNEL.launches, WINDOWED_CORR_BWD_KERNEL.launches
    general = {k.name: k.launches for k in GENERAL_KERNELS}
    want_general = {k.name: general_expected if k is WINDOWED_CORR_MMA_GENERAL_KERNEL else 0
                    for k in GENERAL_KERNELS}
    total_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()

    imgs, flows = out["imgt_pred"], out["flowt"]
    if tuple(imgs.shape) != (len(ts), 1, h, w, 3):
        raise AssertionError(f"{label}: imgt_pred shape {tuple(imgs.shape)}")
    if tuple(flows.shape) != (len(ts), 1, int(h * scale), int(w * scale), 2):
        raise AssertionError(f"{label}: flowt shape {tuple(flows.shape)}")
    if not (bool(torch.isfinite(imgs).all()) and bool(torch.isfinite(flows).all())):
        raise AssertionError(f"{label}: non-finite outputs")
    lo, hi = float(imgs.min()), float(imgs.max())
    if not (lo >= 0.0 and hi <= 1.0):
        raise AssertionError(f"{label}: imgt_pred leaves [0, 1]")
    if (splats != 2 * len(ts) or wins != windowed_expected or tf32 != tf32_expected
            or cuda_core != 0 or atomic != 0 or corr_bwd != 0 or general != want_general):
        raise AssertionError(f"{label}: {splats} splat, {wins} windowed_corr_mma, {tf32} "
                             f"windowed_corr_tf32, {cuda_core} windowed_corr, {atomic} atomic "
                             f"splat and {corr_bwd} windowed_corr_bwd launches, general cases "
                             f"{general}, expected {2 * len(ts)}, {windowed_expected}, "
                             f"{tf32_expected}, 0, 0, 0 and {want_general}")
    del out, imgs, flows

    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(ts) + 2)]
    with torch.inference_mode():
        events[0].record()
        prep = model.prepare(img_xs, ds_factor)
        events[1].record()
        for i, tv in enumerate(ts):
            model.decode_one(prep, tv)
            events[i + 2].record()
    torch.cuda.synchronize()
    decode_ms = [events[i + 1].elapsed_time(events[i + 2]) for i in range(len(ts))]
    return {"fps": len(ts) / (total_ms / 1000), "pair_ms": total_ms,
            "prepare_ms": events[0].elapsed_time(events[1]),
            "decode_ms": statistics.mean(decode_ms), "peak_bytes": peak,
            "splat_launches": splats, "windowed_launches": wins, "tf32_launches": tf32,
            "cuda_core_launches": cuda_core, "general_launches": general,
            "range": (lo, hi)}, prep


def path_lines(phase: int, res: dict) -> str:
    return (f"imgt_pred finite in [{res['range'][0]:.4f}, {res['range'][1]:.4f}]; splat launches "
            f"{res['splat_launches']}, windowed_corr_mma launches {res['windowed_launches']}, "
            f"windowed_corr_tf32 launches {res['tf32_launches']}, "
            f"windowed_corr launches {res['cuda_core_launches']}, general cases "
            f"{res['general_launches']}\n"
            f"[{phase}] {res['fps']:.4f} fps ({res['pair_ms']:.2f} ms per pair); prepare "
            f"{res['prepare_ms']:.2f} ms; decode_one mean {res['decode_ms']:.2f} ms; peak "
            f"allocated {res['peak_bytes']} B ({res['peak_bytes'] / 2**20:.1f} MiB)")


def run_main_path() -> tuple[int, dict]:
    model = init_normal_(GIMMVFI_R(raft_iters=20, dtype=torch.bfloat16), SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    # loading the frames is set-up: they are on the card before the clock starts
    img_xs = torch.rand((1, 2, H, W, 3), generator=gen).cuda()
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    # the 720p volumes (1.16 GB) fit under the limit: no windowed lookup
    res, prep = drive_path(model, img_xs, ts, None, 0, "720p")

    # the splat where it runs: its own device time in a trace of one
    # decode_one (2 launches), then the kernel alone on the inputs the path
    # gave it in that call
    with torch.inference_mode():
        _, by_name = device_ms(lambda: model.decode_one(prep, ts[N_T // 2]), iters=3)
        recorder = SplatRecorder()
        softsplat_ops.SPLAT_SORTED_KERNEL = recorder
        try:
            model.decode_one(prep, ts[N_T // 2])
        finally:
            softsplat_ops.SPLAT_SORTED_KERNEL = SPLAT_SORTED_KERNEL
    row = sorted_rows(by_name)
    in_situ = None if row is None else row / 2
    readings = [sorted_reading(vals, flow, f"[5] sorted splat on the main path's input {k} "
                                           f"{tuple(vals.shape)} at t={ts[N_T // 2]}")
                for k, (vals, flow) in enumerate(recorder.inputs)]
    if len(readings) != 2 or any(tuple(v.shape) != MAIN_SHAPE for v, _ in recorder.inputs):
        raise AssertionError(f"decode_one gave the splat {[tuple(v.shape) for v, _ in recorder.inputs]}")
    splat = {"main_path_in_situ_device_ms": in_situ}
    for key in ("ms", "device_ms", "kernel_device_ms", "plain_ms", "atomic_ms",
                "atomic_kernel_device_ms"):
        values = [r[key] for r in readings]
        splat[f"main_path_{key}"] = None if None in values else statistics.mean(values)
    print(f"[5] the sorted splat's own kernels inside decode_one: device {fmt_ms(in_situ)} a "
          f"launch ({fmt_share(readings[0]['bound_ms'], in_situ)}; its sort not counted)",
          flush=True)
    print(f"[5] main path bf16 {H}x{W} 8x: {path_lines(5, res)}", flush=True)
    return res["splat_launches"], splat, res


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def check_conv() -> float:
    """The conv kernel against conv3x3_plain on the card, elementwise in f32:
    |got - plain| <= 2**-6 |plain| + 1e-4 max|plain| (two bf16 roundings of
    f32 sums taken in another order, plus slack for outputs near zero)."""
    worst = 0.0
    for i, (shape, cout) in enumerate(CONV_CASES):
        x, w = conv_proto.probe_inputs(shape, cout, seed=SEED + i)
        got = CONV3X3_KERNEL(x, w).float()
        ref = conv3x3_plain(x, w).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        limit = 2.0**-6 * ref.abs() + 1e-4 * float(ref.abs().max())
        bad = int((err > limit).sum()) + int((~torch.isfinite(got)).sum())
        print(f"[6] conv3x3 {shape}x(3,3,{shape[3]},{cout}): max_abs_err "
              f"{float(err.max()):.3e}, max|plain| {float(ref.abs().max()):.3e}, "
              f"{bad} elements over the bound", flush=True)
        if bad:
            raise AssertionError(f"conv3x3 kernel disagrees with its plain version at {shape}")
        worst = max(worst, float(err.max()))
    return worst


def check_gathers() -> dict:
    """Each gather kernel against its plain version at its probe shape, and
    with out-of-range and negative indices: exactly equal, NaN at the same
    places (none for subgather_grid, whose `% 512` keeps every index in
    range); subgather first on the ragged tables of `gather_ablate.RAGGED`."""
    rng = np.random.default_rng(SEED)
    worst = {}
    for xn, idxn in gather_ablate.check_tables(SEED)[2:]:
        x, idx = torch.from_numpy(xn).cuda(), torch.from_numpy(idxn).cuda()
        got, ref = SUBGATHER_KERNEL(x, idx), subgather_plain(x, idx)
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        if not (torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], ref[~nan])):
            raise AssertionError(f"subgather kernel differs from its plain version at "
                                 f"{tuple(x.shape)}")
        print(f"[6] subgather {tuple(x.shape)} (ragged) indices in [-rows - 3, rows + 3): equal "
              f"True, NaN {int(nan.sum())}", flush=True)
    for name, (xn, idxn) in gather_cost_probe.gather_tables(SEED).items():
        kernel, plain, _ = GATHERS[name]
        n = xn.shape[1] if name == "lanegather" else xn.shape[0]
        bad_idx = idxn.copy()
        pick = rng.random(idxn.shape) < 0.05
        bad_idx[pick] = rng.choice([-1, -n, n, n + 7, -n - 1, 2**31 - 1, -2**31], int(pick.sum()))
        worst[name] = 0.0
        for label, idx_np in (("probe", idxn), ("out-of-range", bad_idx)):
            x, idx = torch.from_numpy(xn).cuda(), torch.from_numpy(idx_np).cuda()
            got = kernel(x, idx)
            ref = plain(x, idx)
            torch.cuda.synchronize()
            nan = torch.isnan(ref)
            same = torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], ref[~nan])
            n_nan = int(nan.sum())
            err = float((got[~nan] - ref[~nan]).abs().max())
            worst[name] = max(worst[name], err)
            print(f"[6] {name} {tuple(x.shape)} {label} indices: equal {same}, "
                  f"max_abs_err {err:.3e}, NaN {n_nan}", flush=True)
            if not same:
                raise AssertionError(f"{name} kernel differs from its plain version ({label})")
            if label == "out-of-range" and (n_nan == 0) != (name == "subgather_grid"):
                raise AssertionError(f"{name}: wrong NaN fill for out-of-range indices")
    return worst


def run_probes() -> tuple[dict, dict, dict]:
    """The two probe entry points, with the probe kernels' counts from 0."""
    reset_counts()
    conv = conv_proto.main()
    table, gathers = gather_cost_probe.main()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in PROBE_KERNELS}
    print(f"[6] probe kernel launches: {launches}", flush=True)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the probe path launched {name} no time")
    return conv, gathers, launches


def windowed_agrees(label: str, wc, coords, radius: int = 4, kernel=None) -> float:
    """The routed kernel (`windowed_corr_kernel_for` the features' dtype), or
    `kernel` called directly, against the plain version on these inputs, by
    `windowed_agreement`'s tolerance; checks that the kernel launched once;
    prints the line and raises on disagreement. Returns the max-abs error."""
    routed = kernel is None
    kernel = corr_ops.windowed_corr_kernel_for(wc.f1.dtype) if routed else kernel
    before = kernel.launches
    got = (corr_ops.windowed_corr_lookup(wc, coords, radius) if routed
           else kernel(wc, coords.float().contiguous(), radius))
    ref = windowed_corr_lookup_plain(wc, coords, radius)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        raise AssertionError(f"{label}: the lookup did not launch {kernel.name}")
    agree = windowed_agreement(got, ref)
    print(f"{label} ({kernel.name}): max_abs_err {agree['max_abs_err']:.3e}, max|plain| "
          f"{agree['scale']:.3e}, NaN {agree['nan']}, {agree['bad']} over the bound, agrees "
          f"{agree['ok']}", flush=True)
    if not agree["ok"]:
        raise AssertionError(f"windowed kernel disagrees with its plain version: {label}")
    return agree["max_abs_err"]


# (record key prefix, wrapper, the kernel's row in a trace)
WINDOWED_TIMED = [("mma", WINDOWED_CORR_MMA_KERNEL, "windowed_corr_mma_kernel"),
                  ("cuda_core", WINDOWED_CORR_KERNEL, "windowed_corr_kernel")]


def windowed_reading(wc, coords, label: str, levels_mat=None) -> dict:
    """Both windowed kernels on the same bf16 inputs, in the same run, each
    checked against the plain version first: events and device time of each
    against the bound; the tile walk's extents; with `levels_mat` (a
    materialized pyramid of the same maps), that lookup's times beside
    them."""
    nbytes, flops = corr_ops.windowed_corr_work(wc, coords)
    bound, bound_by = bound_ms(nbytes, flops)
    ext = extent_summary(mma_tile_extents(wc, coords), wc.f1.shape[-1])
    out = {"bound_ms": bound, "bound_by": bound_by, "bytes": nbytes, "flops": flops, **ext}
    parts = []
    for key, kernel, row in WINDOWED_TIMED:
        out[f"{key}_max_abs_err"] = windowed_agrees(f"{label}, {kernel.name} called directly",
                                                    wc, coords, kernel=kernel)
        call = lambda k=kernel: k(wc, coords)  # noqa: E731
        ms = cuda_ms(call, warmup=3)
        _, by_name = device_ms(call)
        own = kernel_row(by_name, row)
        out[f"{key}_ms"], out[f"{key}_device_ms"] = ms, own
        parts.append(f"{kernel.name} {ms:.4f} ms by events ({fmt_share(bound, ms)}), device "
                     f"{fmt_ms(own)} ({fmt_share(bound, own)})")
    text = (f"{label} {tuple(coords.shape)} C={wc.f1.shape[-1]} bf16: {'; '.join(parts)}; bound "
            f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
            f"tile walk: {fmt_extent(ext)}")
    if levels_mat is not None:
        mat = lambda: corr_ops.corr_lookup(levels_mat, coords)  # noqa: E731
        out["materialized_ms"] = cuda_ms(mat, warmup=3)
        out["materialized_device_ms"], _ = device_ms(mat)
        text += (f"; materialized corr_lookup (grid_sample over the bf16 volume) "
                 f"{out['materialized_ms']:.4f} ms by events, "
                 f"device {fmt_ms(out['materialized_device_ms'])}")
    print(text, flush=True)
    return out


# radius 3 (GIMMVFI_R's `corr_radius` option) through the two routed forward
# kernels and the backward, beyond the radius-3 case of WINDOWED_CASES
RADIUS3_CASES = [
    (256, torch.bfloat16, "in_frame", 3, 4, (2, 40, 48)),
    (256, torch.float32, "smooth", 3, 4, (2, 40, 48)),
    (24, torch.float32, "border", 3, 3, (1, 13, 23)),
]
RADIUS3_BWD_CASES = [
    (256, torch.float32, "in_frame", 3, 4, (1, 16, 24)),
    (40, torch.bfloat16, "smooth", 3, 4, (2, 13, 23)),
]
# R's constructor options off JAX's defaults (phase 4)
R_OPTIONS = {"num_flows": 2, "fwarp_type": "softmax", "corr_radius": 3, "coord_range": (-0.5, 0.5)}


def check_big_windows() -> dict:
    """The kernels' general case (a radius past 4 or more than 4 levels) in
    `BIG_WINDOW_CASES`, both dtypes, against the plain version under
    `windowed_agreement`'s bounds, through `windowed_corr_lookup` and the
    routed kernel called directly: each call launches the general case once
    a group of at most 4 levels and the fast case never. Returns the largest
    errors by dtype."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (c, dtype, kind, radius, levels, shape) in enumerate(BIG_WINDOW_CASES):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=SEED + 400 + i)
        kernel = corr_ops.windowed_corr_kernel_for(dtype)
        groups = len(corr_ops.level_groups(levels))
        ref = windowed_corr_lookup_plain(wc, coords, radius)
        label = f"[7] general case {shape} C={c} {str(dtype)[6:]} r={radius} L={levels} {kind}"
        for how, call in (("through windowed_corr_lookup",
                           lambda: corr_ops.windowed_corr_lookup(wc, coords, radius)),
                          ("called directly", lambda: kernel(wc, coords, radius))):
            before = (kernel.launches, kernel.general.launches)
            got = call()
            torch.cuda.synchronize()
            if (kernel.launches, kernel.general.launches) != (before[0], before[1] + groups):
                raise AssertionError(f"{label} {how}: launched {kernel.name} "
                                     f"{kernel.launches - before[0]} and {kernel.general.name} "
                                     f"{kernel.general.launches - before[1]} times, expected 0 "
                                     f"and {groups}")
            agree = windowed_agreement(got, ref)
            print(f"{label} {how} ({kernel.general.name}, {groups} launch"
                  f"{'es' if groups > 1 else ''}): max_abs_err {agree['max_abs_err']:.3e}, "
                  f"max|plain| {agree['scale']:.3e}, NaN {agree['nan']}, {agree['bad']} over "
                  f"the bound, agrees {agree['ok']}", flush=True)
            if not agree["ok"]:
                raise AssertionError(f"the general case disagrees with the plain version: {label}")
            worst[dtype] = max(worst[dtype], agree["max_abs_err"])
        del wc, coords, ref, got
    torch.cuda.empty_cache()
    return {"cases": len(BIG_WINDOW_CASES), "max_abs_err_f32": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16]}


def check_big_windows_backward() -> dict:
    """The backward's general case in `BIG_WINDOW_CASES` against
    `windowed_corr_lookup_backward_plain` (`windowed_bwd_agreement`), with
    d_coords and without, two calls of each with bitwise equal d_levels
    (asserted), one general launch a group of levels a call and no fast
    one; then the route: torch.autograd.grad of `windowed_corr_lookup` on
    CUDA tensors against that of the plain lookup, coordinates with and
    without grad, one forward and one backward launch a group."""
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    bwd, gen = WINDOWED_CORR_BWD_KERNEL, WINDOWED_CORR_BWD_GENERAL_KERNEL
    for i, (c, dtype, kind, radius, levels, shape) in enumerate(BIG_WINDOW_CASES):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=SEED + 500 + i)
        g = seeded_g(wc, coords, radius, SEED + 600 + i)
        groups = len(corr_ops.level_groups(levels))
        label = (f"[7] general case backward {shape} C={c} {str(dtype)[6:]} r={radius} "
                 f"L={levels} {kind}")
        plain = windowed_corr_lookup_backward_plain(wc, coords, g, radius)
        for need_coords in (True, False):
            before = (bwd.launches, gen.launches)
            got = bwd(wc, coords, g, radius, need_coords)
            again = bwd(wc, coords, g, radius, need_coords)
            if (bwd.launches, gen.launches) != (before[0], before[1] + 2 * groups) or (
                    got[2] is None) == need_coords:
                raise AssertionError(f"{label}, need_coords {need_coords}: launches "
                                     f"{bwd.launches - before[0]} fast, "
                                     f"{gen.launches - before[1]} general, expected 0 and "
                                     f"{2 * groups}, or its d_coords is wrong")
            what = f"{label}{'' if need_coords else ', without d_coords'}"
            assert_bitwise_repeat(what, got, again)
            agree = bwd_agrees(what, got, plain)
            worst[dtype] = [max(worst[dtype][0], agree["max_abs_err"]),
                            max(worst[dtype][1], agree["coords_max_abs_err"])]
        fwd = corr_ops.windowed_corr_kernel_for(dtype)
        for with_coords in (True, False):
            before = (fwd.general.launches, gen.launches)
            routed = route_grads(wc, coords, radius, corr_ops.windowed_corr_lookup,
                                 SEED + 700 + i, dtype, with_coords)
            if (fwd.general.launches, gen.launches) != (before[0] + groups, before[1] + groups):
                raise AssertionError(f"{label}: the route did not launch {fwd.general.name} and "
                                     f"{gen.name} once a group each")
            ref = route_grads(wc, coords, radius, windowed_corr_lookup_plain, SEED + 700 + i,
                              torch.float32, with_coords)
            bwd_agrees(f"{label}, through windowed_corr_lookup under autograd"
                       f"{'' if with_coords else ', coords without grad'}", routed, ref)
        del wc, coords, g, plain, got, again, routed, ref
    torch.cuda.empty_cache()
    return {"cases": len(BIG_WINDOW_CASES), "max_abs_err_f32": worst[torch.float32][0],
            "max_abs_err_bf16": worst[torch.bfloat16][0],
            "coords_max_abs_err": max(worst[torch.float32][1], worst[torch.bfloat16][1])}


def plain_by_rows(wc, coords, radius: int, rows: int) -> torch.Tensor:
    """`windowed_corr_lookup_plain` over `rows` query rows at a time: the
    same values (the lookup is pointwise in the query), in less memory than
    the whole lookup's gathered windows take at a large radius."""
    n, _, h, w = coords.shape
    c = wc.f1.shape[-1]
    f1 = wc.f1.view(n, h, w, c)
    outs = []
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        part = WindowedCorr(f1[:, r0:r1].reshape(n, -1, c), wc.f2_levels, (r1 - r0, w))
        outs.append(windowed_corr_lookup_plain(part, coords[:, :, r0:r1].contiguous(), radius))
    return torch.cat(outs, dim=2)


def lookup_reading(wc, coords, radius: int, label: str, smi: str, plain_rows: int) -> dict:
    """The routed lookup at `radius` on these inputs (its fast or general
    case, counted), held to the plain version first (`plain_by_rows`,
    `plain_rows` query rows at a time); its events and device time against
    its bound (bf16: bytes, or the dots at the bf16 tensor-core peak;
    float32: bytes, or `TF32_PRODUCTS` TF32 products a float32 one at the
    TF32 peak), the plain version's time and the library composition at the
    same radius and levels (`library_lookup_reading`)."""
    bf16 = wc.f1.dtype == torch.bfloat16
    kernel = corr_ops.windowed_corr_kernel_for(wc.f1.dtype)
    levels = len(wc.f2_levels)
    fast = corr_ops.fast_case(levels, radius)
    counted = kernel if fast else kernel.general
    call = lambda: kernel(wc, coords, radius)  # noqa: E731
    plain = lambda: plain_by_rows(wc, coords, radius, plain_rows)  # noqa: E731
    before = counted.launches
    got, ref = call(), plain()
    torch.cuda.synchronize()
    if counted.launches - before != (1 if fast else len(corr_ops.level_groups(levels))):
        raise AssertionError(f"{label}: {counted.name} launched {counted.launches - before} times")
    agree = windowed_agreement(got, ref)
    if not agree["ok"]:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version ({agree})")
    del got, ref
    nbytes, flops = corr_ops.windowed_corr_work(wc, coords, radius)
    bound, bound_by = (bound_ms(nbytes, flops) if bf16
                       else bound_ms(nbytes, TF32_PRODUCTS * flops, H100_TF32_FLOPS))
    out = {"kernel": counted.name, "radius": radius, "levels": levels,
           "max_abs_err": agree["max_abs_err"], "bound_ms": bound, "bound_by": bound_by,
           "bytes": nbytes, "flops": flops, "ms": cuda_ms(call, warmup=3)}
    _, rows = device_ms(call)
    row = "windowed_corr_mma_kernel" if bf16 else "windowed_corr_tf32_kernel"
    own = [v for k, v in rows.items() if row in k]
    out["device_ms"] = sum(own) if own else None
    out["plain_ms"] = cuda_ms(plain, iters=3)
    out.update(library_lookup_reading(wc, coords, label, radius))
    print(f"{label} {tuple(coords.shape)} C={wc.f1.shape[-1]} {str(wc.f1.dtype)[6:]} r={radius} "
          f"L={levels}: {counted.name} {out['ms']:.4f} ms by events "
          f"({fmt_share(bound, out['ms'])}), device {fmt_ms(out['device_ms'])} "
          f"({fmt_share(bound, out['device_ms'])}); bound {bound:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); plain {out['plain_ms']:.4f} ms "
          f"({plain_rows} query rows at a time); max_abs_err {agree['max_abs_err']:.3e} of "
          f"{agree['scale']:.3e}; {smi}", flush=True)
    torch.cuda.empty_cache()
    return out


def window_readings(smi: str) -> dict:
    """Phase 7: the forward at each (radius, levels) of `WINDOW_READINGS`
    (the fast case, then the general case at radius 8 and at 6 levels), in
    the same run: the bf16 kernel at the 2048x1088 DS 1.0 RAFT lookup
    (2,136,256) and the 3xTF32 kernel at the 720p F AMT lookup (1,92,160),
    C = 256, in-frame coordinates (`lookup_reading`)."""
    out = {}
    for key, shape, dtype, rows, where in (
            ("mma", RAFT_2K, torch.bfloat16, 34, "the 2048x1088 DS 1.0 RAFT lookup"),
            ("tf32", F_AMT_720P, torch.float32, 92, "the 720p F AMT lookup")):
        for radius, levels in WINDOW_READINGS:
            wc, coords, _ = windowed_inputs(shape, 256, dtype, "in_frame", levels, seed=SEED)
            out[f"{key}_r{radius}_l{levels}"] = lookup_reading(
                wc, coords, radius, f"[7] reading at {where}", smi, rows)
            del wc, coords
            torch.cuda.empty_cache()
    return out


def bwd_window_readings(smi: str) -> dict:
    """Phase 7: the backward at radius 8 and at 6 levels (its general case),
    beside the fast case's (b) and (c) readings of the same run: (a) the
    stage-2 AMT lookup (4,28,28) float32 (its fast case too, on these
    inputs), (b) the 720p F AMT lookup (1,92,160) float32 and (c) the
    2048x1088 DS 1.0 RAFT lookup (2,136,256) bf16, in-frame coordinates,
    each beside the yardstick (`bwd_reading`); (a) not at 6 levels, which
    its 28x28 map pools to 1x1 and 0x0 (the yardstick's pooling and sampler
    need 2 px a side). At (c) the plain backward's gathered windows would
    take tens of GB: there the kernel is not held to it (it is at (a), (b)
    and in `check_big_windows_backward`)."""
    out = {}
    for key, shape, dtype in (("a", STAGE2_AMT, torch.float32), ("b", F_AMT_720P, torch.float32),
                              ("c", RAFT_2K, torch.bfloat16)):
        for radius, levels in WINDOW_READINGS:
            if (key != "a" and (radius, levels) == (4, 4)) or (key == "a" and levels > 4):
                continue  # `check_windowed_backward`'s (b) and (c) readings; (a)'s map
            wc, coords, _ = windowed_inputs(shape, 256, dtype, "in_frame", levels, seed=SEED)
            g = seeded_g(wc, coords, radius, SEED + 1)
            out[f"{key}_r{radius}_l{levels}"] = bwd_reading(
                wc, coords, g, f"[7] ({key}) windowed backward at r={radius} L={levels}", smi,
                True, radius, hold=key != "c")
            del wc, coords, g
            torch.cuda.empty_cache()
    return out


def cudnn_enabled(enabled: bool):
    """cuDNN on or off for a block, every other cuDNN setting as it is."""
    b = torch.backends.cudnn
    return b.flags(enabled=enabled, benchmark=b.benchmark, deterministic=b.deterministic,
                   allow_tf32=b.allow_tf32)


def sampler_that_runs(fn) -> tuple[bool, object]:
    """(whether cuDNN is kept, fn's result): fn under cuDNN, or where cuDNN's
    sampler refuses the size (`CUDNN_STATUS_NOT_SUPPORTED`, as `grid_sample`
    at radius 8 over the 2K DS 1.0 volume), fn again with cuDNN off, so that
    `grid_sample` takes PyTorch's own kernel."""
    try:
        return True, fn()
    except RuntimeError as e:
        if "CUDNN_STATUS_NOT_SUPPORTED" not in str(e):
            raise
    with cudnn_enabled(False):
        return False, fn()


def library_lookup_reading(wc, coords, label: str, radius: int = 4) -> dict:
    """The PyTorch composition that computes the lookup from the same maps
    (the state's query features times sqrt(C), its level 0): the
    materialized pyramid under a raised limit (`corr_pyramid_auto`: a bmm
    volume and its pooling) and `corr_lookup` (grid_sample; PyTorch's own
    sampler where cuDNN's refuses the size, `sampler_that_runs`), as one
    call; held to the routed kernel first (max-abs <= 1e-4 max|kernel| in
    float32, 2**-5 in bf16, whose volume is rounded before the sampling);
    its events and device time."""
    n, _, c = wc.f1.shape
    h, w = coords.shape[-2:]
    f1 = (wc.f1.float() * math.sqrt(c)).to(wc.f1.dtype).transpose(1, 2).reshape(n, c, h, w)
    f2 = wc.f2_levels[0].permute(0, 3, 1, 2)

    def composition():
        pyr = corr_ops.corr_pyramid_auto(f1, f2, len(wc.f2_levels), max_volume_bytes=1 << 42)
        return corr_ops.corr_lookup_any(pyr, coords, radius)

    use_cudnn, got = sampler_that_runs(composition)

    def lib():
        with cudnn_enabled(use_cudnn):
            return composition()

    got = got.float()
    want = corr_ops.windowed_corr_lookup(wc, coords, radius).float()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not err <= (1e-4 if wc.f1.dtype == torch.float32 else 2**-5) * scale:
        raise AssertionError(f"{label}: the library composition is {err:.3e} off the kernel "
                             f"(max {scale:.3e})")
    del got, want
    out = {"library_max_abs_err": err, "library_ms": cuda_ms(lib, iters=5, warmup=1),
           "library_sampler": "cuDNN" if use_cudnn else "PyTorch's own (cuDNN refuses the size)"}
    out["library_device_ms"], _ = device_ms(lib, iters=3)
    print(f"{label}: the library composition (corr_pyramid_auto with a raised limit + "
          f"corr_lookup, {str(f1.dtype)[6:]} volume, {out['library_sampler']} grid_sample) "
          f"{out['library_ms']:.4f} ms by events, "
          f"device {fmt_ms(out['library_device_ms'])}; {err:.3e} off the kernel (max {scale:.3e})",
          flush=True)
    torch.cuda.empty_cache()
    return out


def check_windowed() -> dict:
    """Phase 7: the routed windowed kernels against the plain version in the
    check cases (float32 on the 3xTF32 kernel, bf16 on the bf16 tensor-core
    one), at the 2K DS 1.0 path's two lookup shapes, the 720p F path's
    AMT shape and the float32 720p R path's RAFT shape on in-frame and
    smooth coordinates; the float32 lookup against
    the materialized one; then the bf16 kernel's and the CUDA-core kernel's
    times in bf16."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    radius3 = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cuda_core_err = 0.0
    cases = WINDOWED_CASES + MMA_CASES + TF32_CASES + RADIUS3_CASES
    for i, (c, dtype, kind, radius, levels, shape) in enumerate(cases):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=SEED + i)
        label = f"[7] windowed {shape} C={c} {str(dtype)[6:]} r={radius} L={levels} {kind}"
        err = windowed_agrees(label, wc, coords, radius)
        worst[dtype] = max(worst[dtype], err)
        if radius == 3:
            radius3[dtype] = max(radius3[dtype], err)
        # the CUDA-core kernel, timed beside the tensor-core ones, on the
        # float32 cases the route sent it before the 3xTF32 kernel
        if i < len(WINDOWED_CASES) and dtype == torch.float32:
            cuda_core_err = max(cuda_core_err, windowed_agrees(
                f"{label}, called directly", wc, coords, radius, kernel=WINDOWED_CORR_KERNEL))

    # the shapes the 2K DS 1.0 path gives it: RAFT's (both directions) and
    # the AMT's (one direction)
    path_err = 0.0
    for label, shape in (("RAFT", RAFT_2K), ("AMT", AMT_2K)):
        for kind in PATH_KINDS:
            wc, coords, _ = windowed_inputs(shape, 256, torch.bfloat16, kind, seed=SEED)
            path_err = max(path_err, windowed_agrees(
                f"[7] windowed at the 2048x1088 DS 1.0 {label} lookup {shape} C=256 bf16 r=4 L=4 "
                f"{kind}", wc, coords))
            del wc, coords
            torch.cuda.empty_cache()
    # the float32 shapes: the 720p F path's AMT lookup, and the float32
    # 720p R path's RAFT lookup (both directions; the video CLI's)
    for label, shape in (("F AMT", F_AMT_720P), ("R RAFT", RAFT_720P)):
        for kind in PATH_KINDS:
            wc, coords, _ = windowed_inputs(shape, 256, torch.float32, kind, seed=SEED)
            worst[torch.float32] = max(worst[torch.float32], windowed_agrees(
                f"[7] windowed at the 720p {label} lookup {shape} C=256 f32 r=4 L=4 {kind}",
                wc, coords))
            del wc, coords

    # the identity the windowed path rests on, at the 720p fmap
    wc, coords, (f1, f2) = windowed_inputs((1, 92, 160), 256, torch.float32, "in_frame")
    got = corr_ops.windowed_corr_lookup(wc, coords)
    ref = corr_ops.corr_lookup(corr_ops.corr_pyramid(f1, f2), coords)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"[7] windowed_corr_tf32 vs materialized corr_lookup (1, 92, 160) C=256 f32: "
          f"max_abs_err {err:.3e}, max|materialized| {scale:.3e}", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError("windowed and materialized lookups disagree at 720p")
    del wc, coords, f1, f2, got, ref
    torch.cuda.empty_cache()

    stats = {"path_err": path_err, "max_abs_err_cases_f32": worst[torch.float32],
             "max_abs_err_cases_bf16": worst[torch.bfloat16],
             "max_abs_err_radius3_f32": radius3[torch.float32],
             "max_abs_err_radius3_bf16": radius3[torch.bfloat16],
             "cuda_core_max_abs_err_cases_f32": cuda_core_err,
             "tolerance": "bf16 2**-7 |plain| + 1e-6 max|plain|; f32 1e-5 max|plain|",
             "general": check_big_windows()}
    for kind in PATH_KINDS:
        wc, coords, _ = windowed_inputs(RAFT_2K, 256, torch.bfloat16, kind)
        label = f"[7] at the 2048x1088 DS 1.0 RAFT lookup, {kind} coordinates"
        stats[kind] = windowed_reading(wc, coords, label)
        if kind == "in_frame":
            stats["plain_ms"] = cuda_ms(lambda: windowed_corr_lookup_plain(wc, coords), iters=3)
            print(f"[7] plain windowed_corr_lookup_plain there: {stats['plain_ms']:.4f} ms",
                  flush=True)
            stats[kind].update(library_lookup_reading(wc, coords, label))
        del wc, coords
        torch.cuda.empty_cache()
    wc, coords, (f1, f2) = windowed_inputs(RAFT_720P, 256, torch.bfloat16, "in_frame")
    n = RAFT_720P[0] // 2
    fwd, bwd = corr_ops.bidir_corr_pyramid(f1[:n], f2[:n])
    levels = tuple(torch.cat([a, b], dim=0) for a, b in zip(fwd, bwd))
    stats["p720"] = windowed_reading(wc, coords, "[7] at the 720p RAFT lookup, in_frame "
                                     "coordinates", levels)
    del wc, coords, f1, f2, fwd, bwd, levels
    torch.cuda.empty_cache()
    return stats


def bwd_agrees(label: str, got, ref) -> dict:
    """`windowed_bwd_agreement` of the backward's (d_f1, d_levels,
    d_coords) against the plain version's; prints the line and raises on
    disagreement."""
    agree = windowed_bwd_agreement(got, ref)
    parts = "; ".join(f"{k} {v['max_abs_err']:.3e} of {v['scale']:.3e}, NaN {v['nan']}, "
                      f"{v['bad']} over" for k, v in agree["tensors"].items())
    print(f"{label}: {parts}; agrees {agree['ok']}", flush=True)
    if not agree["ok"]:
        raise AssertionError(f"the windowed backward disagrees with its plain version: {label}")
    return agree


def seeded_g(wc, coords, radius: int, seed: int) -> torch.Tensor:
    """A seeded gradient of the lookup's output, in the features' dtype."""
    n, _, h, w = coords.shape
    shape = (n, len(wc.f2_levels) * (2 * radius + 1) ** 2, h, w)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen).to(wc.f1.dtype).to(coords.device)


def route_grads(wc, coords, radius: int, lookup, seed: int, dtype, with_coords: bool = True):
    """torch.autograd.grad of a seeded weighted sum of `lookup`'s output
    with respect to f1, the levels and (`with_coords`) the coordinates, the
    features taken as `dtype` leaves (the same values): (d_f1, d_levels,
    d_coords or None). The weights are rounded to the features' own dtype,
    so that the output's gradient is the same whichever dtype the output
    has."""
    f1 = wc.f1.detach().to(dtype).requires_grad_()
    levels = tuple(x.detach().to(dtype).requires_grad_() for x in wc.f2_levels)
    xy = coords.detach().clone().requires_grad_(with_coords)
    out = lookup(WindowedCorr(f1, levels, wc.shape_hw), xy, radius)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    weight = torch.randn(out.shape, generator=gen).to(wc.f1.dtype).float().to(out.device)
    d = torch.autograd.grad((out.float() * weight).sum(), (f1, *levels, xy)[:len(levels) + 1
                                                                           + with_coords])
    return d[0], d[1:len(levels) + 1], d[-1] if with_coords else None


def assert_bitwise_repeat(label: str, first, second) -> None:
    """Two calls' d_levels must be bitwise equal (the destination side sums
    each element in one fixed order)."""
    if not bitwise_equal(first[1], second[1]):
        diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(first[1], second[1]))
        raise AssertionError(f"{label}: d_levels differ over two calls (max-abs {diff:.3e})")


def fmt_parts(parts: dict) -> str:
    return ", ".join(f"{k} {fmt_ms(v)}" for k, v in parts.items())


def bwd_reading(wc, coords, g, label: str, smi: str, library: bool, radius: int = 4,
                hold: bool = True) -> dict:
    """The backward on these inputs: held to its plain version, two calls'
    d_levels asserted bitwise equal, its events and device time (the whole
    call and its parts, `bwd_parts`) against the bound (`bwd_bound`: the
    bytes, or for each tap on the map its dot again and its d_f1 and d_f2
    products, each at the peak of the tensor-core unit that takes it), the
    same without d_coords (RAFT's mode:
    no dots) against its own bound, the forward kernel's time on the same
    inputs, the plain version's; with `library`, the yardstick: the
    autograd backward of the materialized `corr_lookup` over `corr_pyramid`
    of the same maps (grid_sample's backward, the pooling's and the bmm's),
    its d_fmap1 (d_f1 / sqrt(C)) and d_coords first held to the kernel's
    within 1e-3 x max(1, max|kernel|) in float32 and 2**-5 x max(1,
    max|kernel|) in bf16 (its volume and the maps it starts from are
    rounded to bf16; the kernel's sums are float32). d_coords is held on the queries
    whose position lies at least 1e-3 px from an integer at every level: the
    bilinear weights' derivative jumps at integers, and grid_sample's
    normalized grid rounds a position there to either side. Without `hold`
    the plain version is neither run nor timed (its errors and time None)."""
    call = lambda: WINDOWED_CORR_BWD_KERNEL(wc, coords, g, radius)  # noqa: E731
    first, second = call(), call()
    agree = {"max_abs_err": None, "coords_max_abs_err": None}
    if hold:
        ref = windowed_corr_lookup_backward_plain(wc, coords, g, radius)
        agree = bwd_agrees(f"{label}, held to its plain version", first, ref)
        del ref
    assert_bitwise_repeat(label, first, second)
    work = bwd_bound(wc, coords, radius)
    bound, bound_by, nbytes = work["bound_ms"], work["bound_by"], work["bytes"]
    fwd = corr_ops.windowed_corr_kernel_for(wc.f1.dtype)
    fwd_row = "windowed_corr_mma_kernel" if fwd is WINDOWED_CORR_MMA_KERNEL else "windowed_corr_tf32_kernel"
    out = {"max_abs_err": agree["max_abs_err"], "coords_max_abs_err": agree["coords_max_abs_err"],
           "d_levels_bitwise_repeat": True, "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
           "dot_flops": work["dot_flops"], "product_flops": work["product_flops"]}
    out["ms"] = cuda_ms(call, warmup=2)
    out["device_ms"], rows = device_ms(call, iters=5)
    out["parts_device_ms"] = bwd_parts(out["device_ms"], rows)
    lean = lambda: WINDOWED_CORR_BWD_KERNEL(wc, coords, g, radius, need_coords=False)  # noqa: E731
    lean_bound = bwd_bound(wc, coords, radius, need_coords=False)
    out["no_coords_bound_ms"], out["no_coords_bound_by"] = (lean_bound["bound_ms"],
                                                            lean_bound["bound_by"])
    out["no_coords_ms"] = cuda_ms(lean, warmup=2)
    out["no_coords_device_ms"], rows = device_ms(lean, iters=5)
    out["no_coords_parts_device_ms"] = bwd_parts(out["no_coords_device_ms"], rows)
    out["forward_ms"] = cuda_ms(lambda: fwd(wc, coords, radius), warmup=2)
    out["forward_device_ms"] = kernel_row(device_ms(lambda: fwd(wc, coords, radius))[1], fwd_row)
    out["plain_ms"] = (cuda_ms(lambda: windowed_corr_lookup_backward_plain(wc, coords, g, radius),
                               iters=3) if hold else None)
    out["library_ms"] = out["library_device_ms"] = None
    text = ""
    if library:
        n, p, c = wc.f1.shape
        h, w = coords.shape[-2:]
        fmap1 = (wc.f1.float() * math.sqrt(c)).to(wc.f1.dtype).transpose(1, 2).reshape(n, c, h, w)
        fmap1 = fmap1.detach().requires_grad_()
        fmap2 = wc.f2_levels[0].permute(0, 3, 1, 2).detach().requires_grad_()
        xy = coords.detach().clone().requires_grad_()

        def forward_and_grads():
            vol = corr_ops.corr_lookup(corr_ops.corr_pyramid(fmap1, fmap2, len(wc.f2_levels)),
                                       xy, radius)
            return vol, torch.autograd.grad(vol, (fmap1, fmap2, xy), g, retain_graph=True)

        use_cudnn, (vol, (d_fmap1, _, d_xy)) = sampler_that_runs(forward_and_grads)

        def lib():
            with cudnn_enabled(use_cudnn):
                return torch.autograd.grad(vol, (fmap1, fmap2, xy), g, retain_graph=True)

        want = first[0].float().transpose(1, 2).reshape(n, c, h, w) / math.sqrt(c)
        level_xy = [coords / 2.0**i for i in range(len(wc.f2_levels))]
        clear = torch.stack([(x - x.floor() - 0.5).abs() <= 0.5 - 1e-3 for x in level_xy])
        clear = clear.all(dim=0).all(dim=1, keepdim=True).expand_as(coords)
        gaps = [float((a.float() - b)[m].abs().max()) / max(1.0, float(b[m].abs().max()))
                for a, b, m in ((d_fmap1, want, torch.ones_like(want, dtype=torch.bool)),
                                (d_xy, first[2], clear))]
        if not max(gaps) <= (1e-3 if wc.f1.dtype == torch.float32 else 2**-5):
            raise AssertionError(f"{label}: the yardstick's d_fmap1, d_coords are {gaps} off")
        out["library_gaps"] = gaps
        out["library_queries_held"] = float(clear[:, 0].float().mean())
        out["library_ms"] = cuda_ms(lib, warmup=2)
        out["library_device_ms"], _ = device_ms(lib, iters=5)
        out["library_sampler"] = "cuDNN" if use_cudnn else "PyTorch's own (cuDNN refuses the size)"
        text = (f"; yardstick (autograd backward of the materialized corr_lookup over "
                f"corr_pyramid, {out['library_sampler']} grid_sample, d_fmap1 and d_coords "
                f"{gaps[0]:.2e}, {gaps[1]:.2e} of the "
                f"kernel's, d_coords on {100 * out['library_queries_held']:.2f}% of the "
                f"queries) {out['library_ms']:.4f} ms by events, device "
                f"{fmt_ms(out['library_device_ms'])}")
        del vol, fmap1, fmap2, xy, d_fmap1, d_xy
    plain = "not run" if out["plain_ms"] is None else f"{out['plain_ms']:.4f} ms"
    print(f"{label} {tuple(coords.shape)} C={wc.f1.shape[-1]} {str(wc.f1.dtype)[6:]}: "
          f"{WINDOWED_CORR_BWD_KERNEL.name} {out['ms']:.4f} ms by events "
          f"({fmt_share(bound, out['ms'])}), device {fmt_ms(out['device_ms'])} "
          f"({fmt_share(bound, out['device_ms'])}; {fmt_parts(out['parts_device_ms'])}); bound "
          f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {work['dot_flops'] / 1e9:.2f} "
          f"GFLOP of dots and {work['product_flops'] / 1e9:.2f} GFLOP of products at the "
          f"tensor cores' peaks as the kernel takes them); without d_coords "
          f"{out['no_coords_ms']:.4f} ms by events, device "
          f"{fmt_ms(out['no_coords_device_ms'])} "
          f"({fmt_share(out['no_coords_bound_ms'], out['no_coords_device_ms'])} of its "
          f"{out['no_coords_bound_ms']:.4f} ms {out['no_coords_bound_by']} bound; "
          f"{fmt_parts(out['no_coords_parts_device_ms'])}); the forward "
          f"{fwd.name} {out['forward_ms']:.4f} ms by events, device "
          f"{fmt_ms(out['forward_device_ms'])}; plain {plain}{text}; d_levels "
          f"bitwise equal over two calls; {smi}", flush=True)
    return out


def check_windowed_backward(smi: str) -> dict:
    """Phase 7, the backward: the kernel against
    `windowed_corr_lookup_backward_plain` in `WINDOWED_CASES`, `MMA_CASES`,
    `TF32_CASES` and `WINDOWED_BWD_CASES` (`windowed_bwd_agreement`, one launch a
    call), with d_coords and without (its d_f1 and d_levels), two calls of
    each mode with bitwise equal d_levels (asserted); the route in
    the same cases: torch.autograd.grad of a seeded weighted sum of
    `windowed_corr_lookup`'s output on CUDA tensors against that of
    `windowed_corr_lookup_plain` on the same CUDA tensors (its features as
    float32 leaves of the same values, so that its gradients are float32
    sums cast once), one forward and one backward launch, with the
    coordinates needing a gradient and not; then the kernel's readings
    (`bwd_reading`) at (b) the 720p F path's AMT lookup (1,92,160) float32
    and (c) the 2048x1088 DS 1.0 RAFT lookup (2,136,256) bf16, in-frame
    coordinates (phase 12 (e) takes (a), the stage-2 AMT lookup)."""
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    route_worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    cases = WINDOWED_CASES + MMA_CASES + TF32_CASES + WINDOWED_BWD_CASES + RADIUS3_BWD_CASES
    for i, (c, dtype, kind, radius, levels, shape) in enumerate(cases):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=SEED + 100 + i)
        g = seeded_g(wc, coords, radius, SEED + 200 + i)
        label = f"[7] windowed backward {shape} C={c} {str(dtype)[6:]} r={radius} L={levels} {kind}"
        plain = windowed_corr_lookup_backward_plain(wc, coords, g, radius)
        for need_coords in (True, False):
            before = WINDOWED_CORR_BWD_KERNEL.launches
            got = WINDOWED_CORR_BWD_KERNEL(wc, coords, g, radius, need_coords)
            again = WINDOWED_CORR_BWD_KERNEL(wc, coords, g, radius, need_coords)
            if WINDOWED_CORR_BWD_KERNEL.launches != before + 2 or (got[2] is None) == need_coords:
                raise AssertionError(f"{label}, need_coords {need_coords}: the kernel did not "
                                     f"launch once a call, or its d_coords is wrong")
            what = f"{label}{'' if need_coords else ', without d_coords'}"
            assert_bitwise_repeat(what, got, again)
            agree = bwd_agrees(what, got, plain)
            worst[dtype] = [max(worst[dtype][0], agree["max_abs_err"]),
                            max(worst[dtype][1], agree["coords_max_abs_err"])]
        fwd = corr_ops.windowed_corr_kernel_for(dtype)
        for with_coords in (True, False):
            counts_before = (fwd.launches, WINDOWED_CORR_BWD_KERNEL.launches)
            routed = route_grads(wc, coords, radius, corr_ops.windowed_corr_lookup,
                                 SEED + 300 + i, dtype, with_coords)
            if (fwd.launches, WINDOWED_CORR_BWD_KERNEL.launches) != (counts_before[0] + 1,
                                                                     counts_before[1] + 1):
                raise AssertionError(f"{label}: the route did not launch {fwd.name} and "
                                     f"{WINDOWED_CORR_BWD_KERNEL.name} once each")
            ref = route_grads(wc, coords, radius, windowed_corr_lookup_plain, SEED + 300 + i,
                              torch.float32, with_coords)
            agree = bwd_agrees(f"{label}, through windowed_corr_lookup under autograd"
                               f"{'' if with_coords else ', coords without grad'}", routed, ref)
            route_worst[dtype] = [max(route_worst[dtype][0], agree["max_abs_err"]),
                                  max(route_worst[dtype][1], agree["coords_max_abs_err"])]
        del wc, coords, g, got, again, routed, ref, plain
    torch.cuda.empty_cache()
    res = {"max_abs_err_cases_f32": worst[torch.float32][0],
           "coords_max_abs_err_cases_f32": worst[torch.float32][1],
           "max_abs_err_cases_bf16": worst[torch.bfloat16][0],
           "coords_max_abs_err_cases_bf16": worst[torch.bfloat16][1],
           "route_max_abs_err_f32": route_worst[torch.float32][0],
           "route_max_abs_err_bf16": route_worst[torch.bfloat16][0],
           "route_coords_max_abs_err": max(route_worst[torch.float32][1],
                                           route_worst[torch.bfloat16][1]),
           "tolerance": "f32 d_f1, d_levels 1e-5 max(1, max|plain|), d_coords 1e-4 max(1, "
                        "max|plain|); bf16 d_f1, d_levels 2**-7 |plain| + 1e-6 max|plain|",
           "cases": len(cases)}
    print(f"[7] windowed backward: {len(cases)} cases held to the plain version (with and "
          f"without d_coords; d_levels bitwise equal over two calls in each) and through the "
          f"route (coordinates with and without grad): "
          f"largest d_f1/d_levels error float32 {res['max_abs_err_cases_f32']:.3e}, bf16 "
          f"{res['max_abs_err_cases_bf16']:.3e}; d_coords "
          f"{max(worst[torch.float32][1], worst[torch.bfloat16][1]):.3e}", flush=True)
    for key, shape, dtype, library in (("b", F_AMT_720P, torch.float32, True),
                                       ("c", RAFT_2K, torch.bfloat16, True)):
        wc, coords, _ = windowed_inputs(shape, 256, dtype, "in_frame", seed=SEED)
        g = seeded_g(wc, coords, 4, SEED + 1)
        what = ("the 720p F path's AMT lookup" if key == "b"
                else "the 2048x1088 DS 1.0 RAFT lookup")
        res[key] = bwd_reading(wc, coords, g, f"[7] ({key}) windowed backward at {what}", smi,
                               library)
        del wc, coords, g
        torch.cuda.empty_cache()
    res["general"] = check_big_windows_backward()
    res["readings"] = bwd_window_readings(smi)
    return res


class BwdRecorder:
    """Stands in for the windowed backward kernel in `ops.corr` and keeps a
    copy of the inputs of the calls that ask for d_coords (the AMT's)."""

    def __init__(self, kernel=WINDOWED_CORR_BWD_KERNEL):
        self.kernel, self.calls, self.inputs = kernel, 0, []

    def __call__(self, wc, coords, g, radius=4, need_coords=True):
        self.calls += 1
        if need_coords:
            self.inputs.append((WindowedCorr(wc.f1.clone(), tuple(x.clone() for x in wc.f2_levels),
                                             wc.shape_hw), coords.clone(), g.clone(), radius))
        return self.kernel(wc, coords, g, radius, need_coords)


class LookupRecorder:
    """Stands in for a windowed kernel in `ops.corr` and keeps a copy of the
    inputs of the calls numbered in `keep` (from 0)."""

    def __init__(self, keep, kernel=WINDOWED_CORR_MMA_KERNEL):
        self.keep, self.kernel, self.calls, self.inputs = set(keep), kernel, 0, {}

    def __call__(self, wc, coords, radius=4):
        if self.calls in self.keep:
            self.inputs[self.calls] = (WindowedCorr(wc.f1.clone(), tuple(x.clone() for x in wc.f2_levels),
                                                    wc.shape_hw), coords.clone(), radius)
        self.calls += 1
        return self.kernel(wc, coords, radius)


def path_lookup_readings(model, img_xs, ds) -> dict:
    """The tensor-core kernel where the 2K DS 1.0 path runs it: the inputs
    of the first and the last RAFT lookup of one `prepare`, captured, each
    checked against the plain version and timed beside the CUDA-core
    kernel."""
    iters = model.flow_estimator.iters
    recorder = LookupRecorder([0, iters - 1])
    corr_ops.WINDOWED_CORR_MMA_KERNEL = recorder
    try:
        with torch.inference_mode():
            prep = model.prepare(img_xs, ds)
    finally:
        corr_ops.WINDOWED_CORR_MMA_KERNEL = WINDOWED_CORR_MMA_KERNEL
    del prep
    if recorder.calls != iters or len(recorder.inputs) != 2:
        raise AssertionError(f"prepare made {recorder.calls} windowed lookups, expected {iters}")
    out = {}
    for call, name in ((0, "first"), (iters - 1, "last")):
        wc, coords, radius = recorder.inputs[call]
        label = f"[7] the 2048x1088 DS 1.0 path's {name} RAFT lookup (captured in phase 8 (c))"
        err = windowed_agrees(label, wc, coords, radius)
        out[name] = {**windowed_reading(wc, coords, label), "max_abs_err": err}
    torch.cuda.empty_cache()
    return out


# (label, (H, W), ds_factor, the reference's V100 envelope in MiB or None)
DS_PATHS = [
    ("a", (1088, 2048), 0.5, 7932),
    ("b", (2176, 4096), 0.25, 10922),
    ("c", (1088, 2048), 1.0, None),
]


def run_ds_paths() -> dict:
    """Phase 8: the 2K/4K main paths, then GPU vs CPU at two small points."""
    model = init_normal_(GIMMVFI_R(raft_iters=20, dtype=torch.bfloat16), SEED)
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    results = {}
    for label, (h, w), ds, envelope in DS_PATHS:
        gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
        img_xs = torch.rand((1, 2, h, w, 3), generator=gen).cuda()
        # counted from the code, by each volume's bf16 size against the
        # limit: one lookup each RAFT iteration (both directions batched),
        # two a timestep in the AMT (one a direction)
        fmap = (int(h * ds) // 8) * (int(w * ds) // 8)
        limit = model.corr_max_volume_bytes
        raft_windowed = 2 * (fmap * fmap * 2 * 4 // 3) > limit
        amt_windowed = 2 * fmap * fmap * 2 * 4 // 3 > limit
        expect = model.flow_estimator.iters * raft_windowed + 2 * N_T * amt_windowed
        res, prep = drive_path(model, img_xs, ts, ds, expect, f"({label})")
        del prep
        mib = res["peak_bytes"] / 2**20
        env = (f" (the reference's V100 envelope {envelope} MiB: {100 * mib / envelope:.1f}%)"
               if envelope else "")
        print(f"[8] ({label}) {w}x{h} DS {ds} bf16 8x, working {int(w * ds)}x{int(h * ds)}, "
              f"{'windowed' if expect else 'materialized'} correlation: "
              f"{path_lines(8, res)}{env}", flush=True)
        results[label] = res
        torch.cuda.empty_cache()
        if raft_windowed:
            results["lookups"] = path_lookup_readings(model, img_xs, ds)
        del img_xs
    del model
    torch.cuda.empty_cache()
    results["db_windowed"], results["f32_windowed_launches"] = check_small_e2e(8, (128, 192), None, 0)
    results["db_ds"], _ = check_small_e2e(8, (256, 384), 0.5)
    return results


# (record key, wrapper, the kernel's row in a trace) of the float32 kernels
F32_TIMED = [("tf32", WINDOWED_CORR_TF32_KERNEL, "windowed_corr_tf32_kernel"),
             ("cuda_core", WINDOWED_CORR_KERNEL, "windowed_corr_kernel")]


def f32_lookup_reading(wc, coords, label: str) -> dict:
    """The two float32 windowed kernels on these inputs in the same run, by
    events and device time, each against its bound (`f32_lookup_bounds`:
    the 3xTF32 kernel's three TF32 products a float32 one at the TF32
    tensor-core peak, or its bytes; the CUDA-core kernel's float32
    operations at the CUDA-core peak); the CUDA-core kernel checked
    against the plain version and the 3xTF32 one against the materialized
    `corr_lookup` over a pyramid of the same maps (<= 1e-4 of the largest
    value), whose lookup is timed beside them (the pyramid is built before
    the clock starts); the plain version's time."""
    bounds = f32_lookup_bounds(wc, coords)
    nbytes, flops = bounds["bytes"], bounds["flops"]
    out = {"bytes_bound_ms": 1e3 * nbytes / H100_BYTES_PER_S, "bytes": nbytes, "flops": flops}
    for key in ("tf32", "cuda_core"):
        out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = bounds[key]
    out["cuda_core_max_abs_err"] = windowed_agrees(
        f"{label}, {WINDOWED_CORR_KERNEL.name} called directly", wc, coords,
        kernel=WINDOWED_CORR_KERNEL)
    n, _, c = wc.f1.shape
    h, w = coords.shape[-2:]
    fmap1 = (wc.f1 * math.sqrt(c)).transpose(1, 2).reshape(n, c, h, w)
    levels = corr_ops.corr_pyramid(fmap1, wc.f2_levels[0].permute(0, 3, 1, 2), len(wc.f2_levels))
    got = WINDOWED_CORR_TF32_KERNEL(wc, coords)
    ref = corr_ops.corr_lookup(levels, coords)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"{label}: {WINDOWED_CORR_TF32_KERNEL.name} vs materialized corr_lookup: max_abs_err "
          f"{err:.3e}, max|materialized| {scale:.3e}", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError(f"{label}: the 3xTF32 lookup and the materialized one disagree")
    parts = []
    for key, kernel, row in F32_TIMED:
        call = lambda k=kernel: k(wc, coords)  # noqa: E731
        ms = cuda_ms(call, warmup=3)
        _, by_name = device_ms(call)
        own = kernel_row(by_name, row)
        out[f"{key}_ms"], out[f"{key}_device_ms"] = ms, own
        bound = out[f"{key}_bound_ms"]
        parts.append(f"{kernel.name} {ms:.4f} ms by events ({fmt_share(bound, ms)}), device "
                     f"{fmt_ms(own)} ({fmt_share(bound, own)} {bound:.4f} ms, "
                     f"{out[f'{key}_bound_by']})")
    mat = lambda: corr_ops.corr_lookup(levels, coords)  # noqa: E731
    out["materialized_ms"] = cuda_ms(mat, warmup=3)
    out["materialized_device_ms"], _ = device_ms(mat)
    out["plain_ms"] = cuda_ms(lambda: windowed_corr_lookup_plain(wc, coords), iters=3)
    ext = extent_summary(mma_tile_extents(wc, coords), c, 4)
    out["extent"] = fmt_extent(ext)
    print(f"{label} {tuple(coords.shape)} C={c} f32: {'; '.join(parts)}; materialized "
          f"corr_lookup (grid_sample over the float32 volume) {out['materialized_ms']:.4f} ms "
          f"by events, device {fmt_ms(out['materialized_device_ms'])}; plain "
          f"{out['plain_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP float32 (x3 in TF32), "
          f"{nbytes / 1e6:.1f} MB: {out['bytes_bound_ms']:.4f} ms; tile walk: {out['extent']}",
          flush=True)
    del levels
    out.update(library_lookup_reading(wc, coords, label))
    return out


def decode_turns(model, prep, tv, iters: int = 5) -> dict:
    """`decode_one` by CUDA events with the float32 route's kernel as it is
    and with the CUDA-core kernel in its place, in turns (3xTF32, CUDA
    core, CUDA core, 3xTF32): the lookups' change end to end, in one run."""
    times = {"tf32": [], "cuda_core": []}
    for key in ("tf32", "cuda_core", "cuda_core", "tf32"):
        corr_ops.WINDOWED_CORR_TF32_KERNEL = (WINDOWED_CORR_TF32_KERNEL if key == "tf32"
                                              else WINDOWED_CORR_KERNEL)
        try:
            with torch.inference_mode():
                times[key].append(cuda_ms(lambda: model.decode_one(prep, tv), iters=iters))
        finally:
            corr_ops.WINDOWED_CORR_TF32_KERNEL = WINDOWED_CORR_TF32_KERNEL
    return {k: statistics.mean(v) for k, v in times.items()}


def run_wide_radius_path(smi: str) -> dict:
    """Phase 8 (d): GIMMVFI_R(raft_iters=20, dtype=bfloat16, corr_radius=6)
    at 2048x1088 DS 1.0 on (c)'s seeded pair, 7 timesteps (`drive_path`):
    RAFT's 20 lookups (radius 4) on the bf16 kernel's fast case and the
    AMT's 14 (radius 6, two a timestep) on its general case, exactly; fps,
    the prepare/decode_one split and the peak."""
    model = init_normal_(GIMMVFI_R(raft_iters=20, dtype=torch.bfloat16, corr_radius=6), SEED)
    h, w = DS_PATHS[2][1]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    img_xs = torch.rand((1, 2, h, w, 3), generator=gen).cuda()
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    res, prep = drive_path(model, img_xs, ts, 1.0, model.flow_estimator.iters, "(d)",
                           general_expected=2 * N_T)
    print(f"[8] (d) {w}x{h} DS 1.0 bf16 8x, GIMMVFI_R(raft_iters=20, corr_radius=6), windowed "
          f"correlation (the AMT's radius 6 on the general case): {path_lines(8, res)}; {smi}",
          flush=True)
    del prep, model, img_xs
    torch.cuda.empty_cache()
    return res


def run_f_path(smi: str) -> dict:
    """Phase 9 (a): GIMMVFI_F(ff_iters=32, bf16) at 720p, 7 timesteps. The
    float32 feature map's bidirectional volume (2.31 GB) is over the limit,
    so the AMT looks up the float32 windowed state: 14 launches of the
    3xTF32 kernel a pair. Then the flow estimator alone, `decode_one` with
    either float32 kernel in turns, and both kernels on the inputs of the
    first AMT lookup of one `decode_one`, captured: checked and timed."""
    model = init_normal_(GIMMVFI_F(ff_iters=32, dtype=torch.bfloat16), SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    img_xs = torch.rand((1, 2, H, W, 3), generator=gen).cuda()
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    res, prep = drive_path(model, img_xs, ts, None, 0, "F 720p", tf32_expected=2 * N_T)
    img0, img1 = 255.0 * prep["img0"], 255.0 * prep["img1"]
    with torch.inference_mode():
        res["flow_ms"] = cuda_ms(lambda: model.bidir_flow(img0, img1), iters=3)
        recorder = LookupRecorder([0], WINDOWED_CORR_TF32_KERNEL)
        corr_ops.WINDOWED_CORR_TF32_KERNEL = recorder
        try:
            model.decode_one(prep, ts[N_T // 2])
        finally:
            corr_ops.WINDOWED_CORR_TF32_KERNEL = WINDOWED_CORR_TF32_KERNEL
    res["decode_turns"] = decode_turns(model, prep, ts[N_T // 2])
    print(f"[9] (a) GIMMVFI_F(ff_iters=32) bf16 {H}x{W} 8x, float32 windowed AMT correlation: "
          f"{path_lines(9, res)}; FlowFormer alone (both directions) {res['flow_ms']:.2f} ms; "
          f"decode_one at t={ts[N_T // 2]} in turns: {res['decode_turns']['tf32']:.3f} ms with "
          f"{WINDOWED_CORR_TF32_KERNEL.name}, {res['decode_turns']['cuda_core']:.3f} ms with "
          f"{WINDOWED_CORR_KERNEL.name}; {smi}", flush=True)
    if recorder.calls != 2:
        raise AssertionError(f"decode_one made {recorder.calls} float32 windowed lookups, expected 2")
    del model, prep, img0, img1, img_xs
    torch.cuda.empty_cache()
    wc, coords, radius = recorder.inputs[0]
    label = "[9] (a) the F path's first AMT lookup (captured)"
    res["lookup_max_abs_err"] = windowed_agrees(label, wc, coords, radius)
    res["lookup"] = f32_lookup_reading(wc, coords, label)
    return res


TRACE9 = Path(__file__).resolve().parent / "build" / "chip_smoke_phase9"


def check_bench_trace(lines: list[str]) -> dict:
    """Phase 9 (b)'s `--trace-dir` trace of the R bench: the file its line
    names exists, holds the `prepare` span and 7 `decode_one` spans, and,
    where the card's profiler recorded device activity, device rows of the
    sorted splat's gather kernel (2 a timestep)."""
    (path,) = [line.rsplit(": ", 1)[1] for line in lines if line.startswith("trace of one call")]
    events = json.loads(Path(path).read_text())["traceEvents"]
    # host-side spans (the card's timeline repeats them as gpu_user_annotation)
    names = [e.get("name", "") for e in events if e.get("cat") == "user_annotation"]
    spans = {k: names.count(k) for k in ("prepare", "decode_one")}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    gathers = sum("splat_sorted_gather" in e.get("name", "") for e in kernels)
    if spans != {"prepare": 1, "decode_one": N_T} or (kernels and gathers != 2 * N_T):
        raise AssertionError(f"[9] (b) the trace {path}: spans {spans}, {len(kernels)} kernel "
                             f"rows, {gathers} of the sorted splat's gather")
    print(f"[9] (b) the bench's trace {path} ({Path(path).stat().st_size} bytes): spans {spans}, "
          f"{len(kernels)} kernel rows, "
          + (f"{gathers} of splat_sorted_gather" if kernels
             else "none (the card's profiler recorded no device activity: not measured)"),
          flush=True)
    return {"path": path, "spans": spans, "kernel_rows": len(kernels), "gather_rows": gathers}


def run_bench_entries() -> dict:
    """Phase 9 (b): `gimmvfi_tpu_torch.bench.main` for R and F at 720p, in
    this process; each must print one JSON line, last, with its label. The
    R run also writes a `--trace-dir` trace (`check_bench_trace`)."""
    records = {}
    shutil.rmtree(TRACE9, ignore_errors=True)
    for family in ("r", "f"):
        out = io.StringIO()
        trace = ["--trace-dir", str(TRACE9)] if family == "r" else []
        with contextlib.redirect_stdout(out):
            record = bench.main(["--model", family, *trace])
        lines = out.getvalue().strip().splitlines()
        for line in lines:
            print(f"[9] (b) bench --model {family}: {line}", flush=True)
        label = bench.metric_label(family, "736x1280", None)
        if (json.loads(lines[-1]) != record or record["metric"] != label
                or sum(line.startswith("{") for line in lines) != 1):
            raise AssertionError(f"bench --model {family} printed no single {label} line")
        if (any(k not in record for k in FLOP_FIELDS) or not record["pipeline_flops"] > 0
                or not any(line.startswith("pipeline FLOPs") for line in lines)):
            raise AssertionError(f"bench --model {family}: no pipeline FLOP count, {record}")
        records[family] = record
        if trace:
            records["trace"] = check_bench_trace(lines)
        torch.cuda.empty_cache()
    return records

# ------------------------------------------------------------------ phase 10
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke_phase10"
GIMM_HW = (256, 448)  # Vimeo's frame size, VTF's and VSF's flows
VSF_TS = [t_id / 6.0 for t_id in range(2, 7)]
VIDEO_HW = (720, 1280)
VIDEO_N = 8
X4K_HW = (2160, 4096)


def counts() -> dict:
    return {"splat": SPLAT_SORTED_KERNEL.launches, "splat_atomic": SPLAT_KERNEL.launches,
            "splat_bwd": SPLAT_BACKWARD_KERNEL.launches,
            "tf32": WINDOWED_CORR_TF32_KERNEL.launches,
            "mma": WINDOWED_CORR_MMA_KERNEL.launches, "cuda_core": WINDOWED_CORR_KERNEL.launches,
            "corr_bwd": WINDOWED_CORR_BWD_KERNEL.launches,
            "tf32_general": WINDOWED_CORR_TF32_GENERAL_KERNEL.launches,
            "mma_general": WINDOWED_CORR_MMA_GENERAL_KERNEL.launches,
            "corr_bwd_general": WINDOWED_CORR_BWD_GENERAL_KERNEL.launches}


def expect_counts(label: str, got: dict, splat: int, tf32: int = 0, splat_bwd: int = 0,
                  phase: int = 10, corr_bwd: int = 0, tf32_general: int = 0,
                  corr_bwd_general: int = 0):
    """Exact launch counts of a phase 10 to 13 path: `splat` sorted splats,
    `splat_bwd` splat backwards, `tf32` float32 windowed lookups and
    `tf32_general` of their general case, `corr_bwd` windowed lookup
    backwards and `corr_bwd_general` of their general case, no atomic
    splat, no bf16 or CUDA-core lookup."""
    want = {"splat": splat, "splat_atomic": 0, "splat_bwd": splat_bwd, "tf32": tf32, "mma": 0,
            "cuda_core": 0, "corr_bwd": corr_bwd, "tf32_general": tf32_general,
            "mma_general": 0, "corr_bwd_general": corr_bwd_general}
    if got != want:
        raise AssertionError(f"[{phase}] {label}: launches {got}, expected {want}")


# float32 windowed lookups a GIMMVFI_R(raft_iters=20) pair makes at 720p
# with n_t timesteps: both 1/8-map volumes (92x160 squared, 2 x 1.16 GB) are
# over the 2 GiB limit, so RAFT looks up the windowed state once an
# iteration and the AMT twice a timestep. At X4K's 1024x544 (DS 0.5 of the
# padded 2k frame) they are 2 x 0.40 GB and materialized: no lookup.
def f32_windowed_720p(n_t: int) -> int:
    return 20 + 2 * n_t


def seeded_flows(hw, seed: int):
    """(normalized xs, raw flows), (1, 2, H, W, 2) float32: smooth seeded
    flows of a few pixels, normalized by their largest magnitude as VTF does."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    coarse = torch.randn((2, 2, hw[0] // 16, hw[1] // 16), generator=gen) * 6.0
    ori = torch.nn.functional.interpolate(coarse, size=hw, mode="bilinear", align_corners=False)
    ori = ori.permute(0, 2, 3, 1)[None].contiguous()
    return (ori / ori.abs().max() + 1.0) / 2.0, ori


def run_gimm() -> dict:
    """Phase 10 (a): stage-1 GIMM, float32, at Vimeo's 256x448 on seeded
    flows: one `forward` at t = 0.5 and one `forward_multi` over VSF's five
    timesteps, each after a warm-up, with the counts from 0 (exactly 2 and
    10 splats), by CUDA events; the same calls on the CPU with the same
    seeded weights, PSNR of the normalized flow >= 50 dB."""
    xs, ori = seeded_flows(GIMM_HW, SEED + 3)
    t = torch.tensor([0.5])
    gpu, cpu = (init_normal_(GIMM(device=d), SEED).eval() for d in (None, "cpu"))
    res = {}
    with torch.inference_mode():
        for label, call, n_splat in (
                ("forward", lambda m: m(xs, ori, t), 2),
                ("forward_multi", lambda m: m.forward_multi(xs, ori, VSF_TS), 2 * len(VSF_TS))):
            call(gpu)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            got, ms = bench.timed(lambda: call(gpu), torch.device("cuda"))
            got_counts = counts()
            expect_counts(f"(a) GIMM.{label}", got_counts, n_splat)
            db = psnr(got.cpu(), call(cpu))
            print(f"[10] (a) GIMM.{label} float32 {GIMM_HW[0]}x{GIMM_HW[1]}: {ms:.3f} ms by "
                  f"events, {n_splat} splat launches, output {tuple(got.shape)}, GPU vs CPU "
                  f"{db:.2f} dB", flush=True)
            if not (bool(torch.isfinite(got).all()) and db >= 50.0):
                raise AssertionError(f"[10] (a) GIMM.{label}: non-finite or GPU vs CPU {db:.2f} dB")
            res[label] = {"ms": ms, "db": db, "launches": got_counts}
    res["ms_per_t"] = res["forward_multi"]["ms"] / len(VSF_TS)
    return res


def reference_checkpoint(model: torch.nn.Module, path: Path, extras: dict) -> str:
    """Save `model`'s weights as a reference training checkpoint has them: a
    `state_dict` wrapper, DDP `module.` prefixes and keys the port holds
    no parameter for (`extras`)."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    sd.update(extras)
    sd.update({f"{k[:-len('running_mean')]}num_batches_tracked": torch.tensor(0)
               for k in list(sd) if k.endswith("running_mean")})
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    return str(path)


def seeded_frames(hw, k: int, seed: int) -> list[np.ndarray]:
    """k (H, W, 3) uint8 frames: shifted crops of one seeded smooth image,
    so the pair has motion to find."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    big = (hw[0] + 4 * k, hw[1] + 8 * k)
    coarse = torch.rand((1, 3, big[0] // 8, big[1] // 8), generator=gen)
    img = torch.nn.functional.interpolate(coarse, size=big, mode="bilinear", align_corners=False)
    img = (img[0].permute(1, 2, 0).numpy() * 255).astype(np.uint8)
    return [np.ascontiguousarray(img[4 * i:4 * i + hw[0], 8 * i:8 * i + hw[1]]) for i in range(k)]


def run_video_cli(smi: str) -> dict:
    """Phase 10 (b): `video_nx.main` on three seeded 720x1280 PPM frames
    with a seeded R checkpoint in the reference's layout, 8x, float32, on
    the card, counts from 0: 2 pairs, 1 + 2 x 8 frames, 28 splats and
    2 x 34 float32 windowed lookups. Then, on a model loaded from the same
    checkpoint, the first pair through `interpolate_pair` against
    `interpolate_sequential` on inputs padded here (<= 1e-5 max-abs, the
    bound kept from the atomic splat's run-to-run order; one process
    against itself printed beside it), the CLI's frames of that pair
    against the latter's quantized (<= 1 level), and the inputs of the
    pair's first RAFT and first AMT lookup, captured, against the plain
    version."""
    src = WORK / "video_frames"
    src.mkdir(parents=True)
    for i, frame in enumerate(seeded_frames(VIDEO_HW, 3, SEED + 4)):
        write_ppm(str(src / f"{i:03d}.ppm"), frame)
    model = init_normal_(GIMMVFI_R(raft_iters=20), SEED)
    ckpt = reference_checkpoint(model, WORK / "gimmvfi_r_random.pt",
                                {"g_filter": torch.full((1, 1, 3, 3), 1 / 9)})
    del model
    torch.cuda.empty_cache()
    n_t = VIDEO_N - 1

    out_dir = WORK / "video_out"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = video_nx.main(["--source-path", str(src), "--N", str(VIDEO_N), "--ckpt", ckpt,
                         "--output-path", str(out_dir)])
    total_s = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    n_frames = 1 + 2 * VIDEO_N
    if len(res["pair_ms"]) != 2 or len(res["frames"]) != n_frames:
        raise AssertionError(f"[10] (b) {len(res['pair_ms'])} pairs, {len(res['frames'])} frames")
    expect_counts("(b) video CLI", got, 2 * 2 * n_t, 2 * f32_windowed_720p(n_t))
    written = res["written"]["output"]
    if written.endswith(".frames"):
        names = sorted(os.listdir(written))
        if len(names) != n_frames:
            raise AssertionError(f"[10] (b) {len(names)} PPM frames in {written}")
        if not np.array_equal(read_ppm(os.path.join(written, names[1])), res["frames"][1]):
            raise AssertionError("[10] (b) the PPM written is not the frame made")
    elif not os.path.getsize(written):
        raise AssertionError(f"[10] (b) {written} is empty")
    print(f"[10] (b) video_nx.main {VIDEO_HW[0]}x{VIDEO_HW[1]} float32 8x: 2 pairs, {len(res['frames'])} frames "
          f"written to {written}; launches {got}; ms a pair (host clock around interpolate_pair): "
          f"{', '.join(f'{ms:.2f}' for ms in res['pair_ms'])}; the whole CLI {total_s:.2f} s; "
          f"peak allocated {peak / 2**20:.1f} MiB; {smi}", flush=True)

    # the first pair again on a reloaded model: interpolate_pair, with the
    # float32 lookups' inputs captured, against interpolate_sequential on
    # inputs padded here
    i0, i1 = (read_image(str(src / f"{i:03d}.ppm")) for i in range(2))
    model = video_nx.load_model(ckpt)
    raft_iters = model.flow_estimator.iters
    recorder = LookupRecorder([0, raft_iters], WINDOWED_CORR_TF32_KERNEL)
    corr_ops.WINDOWED_CORR_TF32_KERNEL = recorder
    try:
        pair, _ = video_nx.interpolate_pair(model, i0, i1, VIDEO_N, None)
    finally:
        corr_ops.WINDOWED_CORR_TF32_KERNEL = WINDOWED_CORR_TF32_KERNEL
    padder = InputPadder(VIDEO_HW, 32)
    xs = padder.pad(torch.from_numpy(np.stack([i0, i1])).permute(0, 3, 1, 2))
    ref, again = (interpolate_sequential(model, xs.permute(0, 2, 3, 1)[None].cuda(),
                                         [i / VIDEO_N for i in range(1, VIDEO_N)])["imgt_pred"]
                  for _ in range(2))
    rerun_err = float((again - ref).abs().max())
    del again
    ref = padder.unpad(ref[:, 0].permute(0, 3, 1, 2)).permute(0, 2, 3, 1).cpu().numpy()
    pair = np.stack(pair)
    pair_err, pair_db = float(np.abs(pair - ref).max()), psnr(torch.from_numpy(pair), torch.from_numpy(ref))
    cli_frames = np.stack([f[:, VIDEO_HW[1]:] for f in res["frames"][1:VIDEO_N]])
    levels = int(np.abs(cli_frames.astype(np.int16) - (np.clip(ref, 0, 1) * 255).astype(np.uint8)
                        ).max())
    print(f"[10] (b) the first pair: interpolate_pair vs interpolate_sequential on inputs padded "
          f"here: max_abs_err {pair_err:.3e}, {pair_db:.2f} dB (one process against itself: "
          f"{rerun_err:.3e}); "
          f"the CLI's frames vs the latter quantized: {levels} level(s) apart; "
          f"{recorder.calls} float32 windowed lookups", flush=True)
    if not (pair_err <= 1e-5 and levels <= 1 and recorder.calls == f32_windowed_720p(n_t)):
        raise AssertionError(f"[10] (b) the first pair: {pair_err:.3e} off, CLI frames {levels} "
                             f"levels off, {recorder.calls} float32 windowed lookups")
    del model, pair, ref
    torch.cuda.empty_cache()
    lookup_err = {}
    for call, label, shape in ((0, "RAFT", RAFT_720P), (raft_iters, "AMT", F_AMT_720P)):
        wc, coords, radius = recorder.inputs[call]
        if (coords.shape[0], *coords.shape[-2:]) != shape or wc.f1.dtype != torch.float32:
            raise AssertionError(f"[10] (b) the first {label} lookup: {tuple(coords.shape)} "
                                 f"{wc.f1.dtype}, expected {shape} float32")
        lookup_err[label] = windowed_agrees(
            f"[10] (b) the video CLI pair's first {label} lookup {shape} C={wc.f1.shape[-1]} f32 "
            f"(captured)", wc, coords, radius)
    del recorder
    torch.cuda.empty_cache()
    return {"pair_ms": res["pair_ms"], "total_s": total_s, "peak_bytes": peak,
            "launches": got, "pair_err": pair_err, "rerun_err": rerun_err,
            "lookup_max_abs_err": lookup_err, "ckpt": ckpt}


def harness(argv: list[str]) -> tuple[dict, dict, float]:
    """One harness through `benchmarks.main` with the counts from 0: its
    result (the JSON line it printed last, which must be finite), the
    launches and its seconds."""
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = bench_cli.main(argv)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"[10] (c) {argv[0]}: {line}", flush=True)
    values = [v for r in (res.values() if argv[0] == "snu_film_arb" else [res])
              for v in r.values()]
    if json.loads(lines[-1]) != json.loads(json.dumps(res)) or not all(
            v is not None and math.isfinite(v) for v in values):
        raise AssertionError(f"[10] (c) {argv[0]}: no finite JSON result last")
    return res, counts(), seconds


def run_harnesses(vfi_ckpt: str) -> dict:
    """Phase 10 (c): the four harnesses on fabricated data, float32 on the
    card: SNU-FILM-arb medium (one row of five 720x1280 frames) with a
    seeded LPIPS checkpoint; X4K 2k, with it too (one scene of 33 4096x2160 frames,
    links to three distinct ones: 7 items at DS 0.5); VTF and VSF on
    seeded 256x448 `.flo` files with a seeded GIMM checkpoint. Each JSON
    result finite; exact launch counts."""
    root = WORK / "data"
    lpips = reference_checkpoint(
        init_normal_(LPIPS(), SEED), WORK / "lpips_random.pt",
        {"scaling_layer.shift": torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
         "scaling_layer.scale": torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)})
    gimm = reference_checkpoint(init_normal_(GIMM(), SEED), WORK / "gimm_random.pt",
                                {"g_filter": torch.full((1, 1, 3, 3), 1 / 9)})
    results = {}

    snu = root / "snu"
    (snu / "frames").mkdir(parents=True)
    row = []
    for k, frame in enumerate(seeded_frames(VIDEO_HW, 5, SEED + 5)):
        write_ppm(str(snu / "frames" / f"{k}.ppm"), frame)
        row.append(f"frames/{k}.ppm")
    (snu / "test-arb-medium.txt").write_text(" ".join(row) + "\n")
    res, got, sec = harness(["snu_film_arb", "--data-root", str(snu), "--ckpt", vfi_ckpt,
                             "--lpips-path", lpips])
    expect_counts("(c) snu_film_arb", got, 2 * 3, f32_windowed_720p(3))
    results["snu_film_arb"] = {"result": res, "launches": got, "seconds": sec}

    scene = root / "x4k" / "Type1" / "TEST01"
    scene.mkdir(parents=True)
    distinct = [WORK / f"x4k_{k}.ppm" for k in range(3)]
    for path, frame in zip(distinct, seeded_frames(X4K_HW, 3, SEED + 6)):
        write_ppm(str(path), frame)
    for i in range(33):
        os.symlink(distinct[0 if i == 0 else 2 if i == 32 else 1], scene / f"{i:04d}.ppm")
    res, got, sec = harness(["x4k", "--data-root", str(root / "x4k"), "--ckpt", vfi_ckpt,
                             "--split", "2k", "--lpips-path", lpips])
    expect_counts("(c) x4k 2k", got, 2 * 7)
    results["x4k"] = {"result": res, "launches": got, "seconds": sec}

    rng = np.random.default_rng(SEED + 7)
    seqs = ["00001/0001", "00001/0002"]
    for bench_name, names, listing in (
            ("vtf", ["im1_im3", "im2_im3", "im2_im1", "im3_im1"], "tri_testlist.txt"),
            ("vsf", ["im1_im7", "im7_im1"] + [f"im{t}_im{e}" for t in range(2, 7) for e in (1, 7)],
             "sep_testlist.txt")):
        data = root / bench_name
        for seq in seqs:
            (data / "flow_sequences" / seq).mkdir(parents=True)
            for name in names:
                _, flow = seeded_flows(GIMM_HW, int(rng.integers(1 << 30)))
                write_flo(str(data / "flow_sequences" / seq / f"{name}.flo"), flow[0, 0].numpy())
        (data / listing).write_text("\n".join(seqs) + "\n")
        res, got, sec = harness([bench_name, "--data-root", str(data), "--ckpt", gimm])
        per_seq = 1 if bench_name == "vtf" else len(VSF_TS)
        expect_counts(f"(c) {bench_name}", got, 2 * per_seq * len(seqs))
        results[bench_name] = {"result": res, "launches": got, "seconds": sec}
    print(f"[10] (c) harness seconds: "
          f"{', '.join(f'{k} {v['seconds']:.2f}' for k, v in results.items())}", flush=True)
    return results


def run_phase10(smi: str) -> dict:
    """Phase 10: stage-1 GIMM, the video CLI and the four harnesses, in a
    scratch directory under build/."""
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    gimm = run_gimm()
    video = run_video_cli(smi)
    harnesses = run_harnesses(video["ckpt"])
    print(f"[10] phase 10 took {time.perf_counter() - t0:.2f} s", flush=True)
    return {"gimm": gimm, "video": video, "harnesses": harnesses}


# ------------------------------------------------------------------ phase 11
WORK11 = Path(__file__).resolve().parent / "build" / "chip_smoke_phase11"
RECIPE = "configs/gimm/gimm.yaml"  # stage-1 GIMM: Adam, lr 1e-4, batch 32, 256^2 crop
CROP = 256  # the flow dataset's crop (`data/flow_dataset.py`); TRAIN_SPLAT's H and W
TIMED_STEPS = 10


def check_backward() -> dict:
    """Phase 11 (a): the backward kernel against `splat_sum_backward_plain`
    in `BWD_CASES` (the recipe step's (32, 256, 256, 17) on a random, a
    smooth and a non-finite/far field, the small `CHECK_CASES`, C above one
    d_flow chunk, W off the 32-column tile): d_vals and d_flow <= 1e-5 x
    max(1, max|plain|), and d_vals alone (no d_flow) equal to the full
    call's. Then, at the recipe shape on the random and the non-finite
    field, two calls in each mode must give the same bits. Then its times
    there in both modes (events and device rows, against each mode's
    bound) beside the plain version's, the forward kernel's and the PyTorch
    yardsticks' (`F.grid_sample` for d_vals, `aten.grid_sampler_2d_backward`
    for d_flow; each held to the plain version first)."""
    worst, worst_share = 0.0, 0.0
    for i, (shape, field, std) in enumerate(BWD_CASES):
        vals, flow, g = bwd_inputs(shape, field, std, SEED + i)
        d_vals, d_flow = SPLAT_BACKWARD_KERNEL(vals, flow, g)
        d_vals_only, none = SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=False)
        ref_vals, ref_flow = splat_sum_backward_plain(vals, flow, g)
        torch.cuda.synchronize()
        errs = []
        for what, got, ref in (("d_vals", d_vals, ref_vals), ("d_flow", d_flow, ref_flow)):
            err = float((got - ref).abs().max())
            bound = 1e-5 * max(1.0, float(ref.abs().max()))
            errs.append(f"{what} {err:.3e} (bound {bound:.3e})")
            if not err <= bound:
                raise AssertionError(f"[11] (a) splat backward {what} disagrees with the plain "
                                     f"version at {shape} {field}: {err:.3e} > {bound:.3e}")
            worst, worst_share = max(worst, err), max(worst_share, err / bound)
        if none is not None or not torch.equal(d_vals_only, d_vals):
            raise AssertionError(f"[11] (a) d_vals without d_flow differs at {shape} {field}")
        print(f"[11] (a) splat backward {shape} {field} flow std {std}: {'; '.join(errs)}",
              flush=True)
        del vals, flow, g, d_vals, d_flow, d_vals_only, ref_vals, ref_flow
    torch.cuda.empty_cache()

    for field in ("random", "non_finite"):
        vals, flow, g = bwd_inputs(TRAIN_SPLAT, field, TRAIN_STD, SEED)
        for need_flow in (True, False):
            first = SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=need_flow)
            second = SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=need_flow)
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(first, second) if a is not None]
            if not all(same):
                raise AssertionError(f"[11] (a) two calls of the backward differ at {TRAIN_SPLAT} "
                                     f"{field}, need_flow={need_flow}: equal {same}")
        print(f"[11] (a) splat backward {TRAIN_SPLAT} {field}: two calls give the same bits, "
              f"d_vals and d_flow, in both modes", flush=True)
        del vals, flow, g, first, second
    torch.cuda.empty_cache()

    stats = {"max_abs_err": worst, "max_err_over_bound": worst_share,
             "tolerance": "1e-5 max(1, max|plain|), d_vals and d_flow", "deterministic": True}
    for field in ("random", "smooth"):
        vals, flow, g = bwd_inputs(TRAIN_SPLAT, field, TRAIN_STD, SEED)
        bound, bound_by = splat_bwd_bound(vals)
        vals_bound = splat_bwd_bound(vals, need_flow=False)[0]
        ms = cuda_ms(lambda: SPLAT_BACKWARD_KERNEL(vals, flow, g), warmup=3)
        _, rows = device_ms(lambda: SPLAT_BACKWARD_KERNEL(vals, flow, g))
        dev = kernel_row(rows, "splat_sum_bwd_kernel")
        vals_ms = cuda_ms(lambda: SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=False), warmup=3)
        _, rows = device_ms(lambda: SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=False))
        vals_dev = kernel_row(rows, "splat_sum_bwd_kernel")
        plain_ms = cuda_ms(lambda: splat_sum_backward_plain(vals, flow, g), iters=5)
        fwd_ms = cuda_ms(lambda: SPLAT_KERNEL(vals, flow), warmup=3)
        _, fwd_rows = device_ms(lambda: SPLAT_KERNEL(vals, flow))
        fwd_dev = kernel_row(fwd_rows, "splat_sum_kernel")
        fwd_bound = splat_bound(vals)[0]
        label = f"[11] (a) splat backward {TRAIN_SPLAT} {field} flow std {TRAIN_STD:g}"
        lib = yardstick_readings(vals, flow, g, label=label)
        lib_ms = lib["d_vals"]["ms"] + lib["d_flow"]["ms"]
        lib_dev = (None if lib["d_vals"]["device_ms"] is None or lib["d_flow"]["device_ms"] is None
                   else lib["d_vals"]["device_ms"] + lib["d_flow"]["device_ms"])
        print(f"{label}: full (d_vals and d_flow) {ms:.4f} ms by events ({fmt_share(bound, ms)}), "
              f"device {fmt_ms(dev)} ({fmt_share(bound, dev)}), bound {bound:.4f} ms "
              f"({bound_by}); d_vals alone {vals_ms:.4f} ms by events, device {fmt_ms(vals_dev)} "
              f"({fmt_share(vals_bound, vals_dev)} of {vals_bound:.4f} ms); yardsticks: "
              f"F.grid_sample {fmt_ms(lib['d_vals']['device_ms'])} device, with the d_flow call "
              f"{fmt_ms(lib_dev)}; plain {plain_ms:.4f} ms; the forward kernel there "
              f"{fwd_ms:.4f} ms by events, device {fmt_ms(fwd_dev)} "
              f"({fmt_share(fwd_bound, fwd_dev)} of {fwd_bound:.4f} ms)", flush=True)
        reading = {"ms": ms, "device_ms": dev, "d_vals_only_ms": vals_ms,
                   "d_vals_only_device_ms": vals_dev, "d_vals_only_bound_ms": vals_bound,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": lib_ms, "library_device_ms": lib_dev,
                   "library_d_vals_ms": lib["d_vals"]["ms"],
                   "library_d_vals_device_ms": lib["d_vals"]["device_ms"],
                   "library_d_flow_ms": lib["d_flow"]["ms"],
                   "library_d_flow_device_ms": lib["d_flow"]["device_ms"],
                   "forward_ms": fwd_ms, "forward_device_ms": fwd_dev,
                   "forward_bound_ms": fwd_bound, "forward_library_ms": lib["forward"]["ms"],
                   "forward_library_device_ms": lib["forward"]["device_ms"]}
        if field == "random":
            stats.update(reading, library_call="F.grid_sample (d_vals) + "
                         "aten.grid_sampler_2d_backward grid gradient (d_flow)",
                         library_layout={k: v["layout"] for k, v in lib.items()},
                         library_max_abs_err={k: v["max_abs_err"] for k, v in lib.items()})
        else:
            stats.update({f"smooth_{k}": v for k, v in reading.items() if k != "bound_by"})
        del vals, flow, g
    torch.cuda.empty_cache()
    return stats


def flow_batch(n: int, hw, seed: int, device="cuda") -> dict:
    """A stage-1 batch as `data/flow_dataset.py` makes it, from seeded
    smooth flows of a few pixels: xs (N, 3, H, W, 2) normalized by the
    endpoint flows' largest magnitude, ori_flows (N, 2, H, W, 2)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    coarse = torch.randn((n * 3, 2, hw[0] // 16, hw[1] // 16), generator=gen) * 4.0
    flows = torch.nn.functional.interpolate(coarse, size=hw, mode="bilinear",
                                            align_corners=False)
    flows = flows.view(n, 3, 2, *hw).permute(0, 1, 3, 4, 2).contiguous()
    scaler = flows[:, [0, 2]].abs().amax(dim=(1, 2, 3, 4)).view(n, 1, 1, 1, 1)
    return {"xs": ((flows / scaler + 1.0) / 2.0).to(device),
            "ori_flows": torch.stack([flows[:, 0], -flows[:, 2]], dim=1).to(device)}


def recipe_state(cfg, device=None, seed=SEED, remat=True):
    """GIMM from a seed (its own initialization), with remat as the train
    CLI builds it unless told, and the recipe's optimizer."""
    torch.manual_seed(seed)
    model = GIMM(device=device, remat=remat)
    o = cfg.optimizer
    opt, sched = create_optimizer(model, o.type, init_lr=o.init_lr, weight_decay=o.weight_decay,
                                  betas=tuple(o.betas), ft=o.ft, max_grad_norm=o.max_gn)
    return create_train_state(model, opt, sched, use_ema=bool(cfg.arch.ema))


def run_recipe_step(smi: str) -> dict:
    """Phase 11 (b): the recipe's step on the card, float32, TF32 off:
    GIMM, Adam lr 1e-4, batch 32 at 256^2 on seeded smooth flows, one t_id
    a step. One step counted from 0 (exactly 2 forward and 2 backward
    splat launches, no windowed lookup), 2 more warm-ups, then 10 timed by
    CUDA events: median ms a step, peak allocated, loss finite, parameters
    moved; then the device time of one step and of its splats in a trace."""
    cfg = load_config(RECIPE)
    n = cfg.experiment.batch_size
    state = recipe_state(cfg)
    step = make_gimm_train_step(use_ema=bool(cfg.arch.ema))
    batch = flow_batch(n, (CROP, CROP), SEED + 11)
    rng = np.random.default_rng(SEED)

    def one():
        batch["t_id"] = np.full((n,), rng.integers(0, 3), np.int32)
        return step(state, batch)

    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    one()
    torch.cuda.synchronize()
    got = counts()
    expect_counts("(b) the recipe step", got, 2, splat_bwd=2, phase=11)
    one()
    one()
    times, losses = [], []
    for _ in range(TIMED_STEPS):
        metrics, ms = bench.timed(one, torch.device("cuda"))
        times.append(ms)
        losses.append(float(metrics["loss_total"]))
    peak = torch.cuda.max_memory_allocated()
    moved = max(float((v - before[k]).abs().max()) for k, v in state.model.state_dict().items())
    if not (all(math.isfinite(x) for x in losses) and moved > 0):
        raise AssertionError(f"[11] (b) losses {losses}, largest parameter move {moved}")
    step_dev, rows = device_ms(one, iters=1, warmup=0)
    fwd = sorted_rows(rows)
    bwd = kernel_row(rows, "splat_sum_bwd_kernel")
    med = statistics.median(times)
    splat_dev = None if fwd is None or bwd is None else fwd + bwd
    print(f"[11] (b) the recipe step ({RECIPE}: {cfg.optimizer.type} lr {cfg.optimizer.init_lr}, "
          f"batch {n}, {CROP}x{CROP}, float32): {med:.2f} ms a step (median of {TIMED_STEPS} by "
          f"events; {min(times):.2f}-{max(times):.2f}); peak allocated {peak / 2**20:.1f} MiB; "
          f"launches a step {got}; losses {losses[0]:.5f} -> {losses[-1]:.5f}; largest parameter "
          f"move {moved:.3e}; device time of one traced step {fmt_ms(step_dev)} (the "
          f"trace's rows, summed); its splats: forward {fmt_ms(fwd)} (2 launches), backward "
          f"{fmt_ms(bwd)} (2 launches), "
          f"{'not measured' if splat_dev is None else f'{100 * splat_dev / med:.2f}%'} of the "
          f"step; {smi}", flush=True)
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:6]
    print(f"[11] (b) the step's largest device rows: "
          f"{'; '.join(f'{v:.3f} ms {k[:70]}' for k, v in top)}", flush=True)
    res = {"step_ms": med, "step_ms_all": times, "peak_bytes": peak, "launches": got,
           "losses": losses, "step_device_ms": step_dev, "splat_fwd_device_ms": fwd,
           "splat_bwd_device_ms": bwd}
    del state, batch
    torch.cuda.empty_cache()
    return res


GRAD_SEEDS = (SEED, SEED + 1, SEED + 2)  # phase 11 (c): weights and batch of each reading
GPU_RERUNS = 2  # the card's step from the same weights, for its own atomic order
ALPHAS = ("alpha_v", "alpha_fe")  # GIMM's scalar splat-weight parameters


@contextlib.contextmanager
def alpha_fields(module):
    """For the one step run inside, the fields that the gradients of
    `ALPHAS` contract, read through `module.splatting_weights`: u =
    dL/d(w1, w2), the gradient reaching the splat weights, and for each
    alpha c = d(w1, w2)/d alpha, pixel by pixel (forward mode); flattened
    to float64 on the CPU into the dict yielded."""
    weights_fn, fields, out = module.splatting_weights, {}, {}

    def spy(flow01, flow10, alpha_v, alpha_fe):
        w1, w2 = weights_fn(flow01, flow10, alpha_v, alpha_fe)
        w1.retain_grad()
        w2.retain_grad()
        f01, f10, a_v, a_fe = (x.detach() for x in (flow01, flow10, alpha_v, alpha_fe))
        one = torch.ones_like(a_v)
        fields["alpha_v"] = torch.func.jvp(lambda a: weights_fn(f01, f10, a, a_fe), (a_v,), (one,))[1]
        fields["alpha_fe"] = torch.func.jvp(lambda a: weights_fn(f01, f10, a_v, a), (a_fe,), (one,))[1]
        fields["w"] = (w1, w2)
        return w1, w2

    module.splatting_weights = spy
    try:
        yield out
    finally:
        module.splatting_weights = weights_fn
    w1, w2 = fields.pop("w")
    flat = lambda pair: torch.cat([t.detach().reshape(-1) for t in pair]).cpu().double()
    out.update({"u": flat((w1.grad, w2.grad)), **{k: flat(v) for k, v in fields.items()}})


def step_fields(cfg, device: str, weights: dict, batch: dict) -> dict:
    """One recipe step from `weights` on `batch`: the loss, each parameter's
    gradient (on the CPU), the fields of the alphas' gradients
    (`alpha_fields`) and the state dict after the step (on the CPU)."""
    state = recipe_state(cfg, device=device)
    state.model.load_state_dict(weights)
    with alpha_fields(gimm_model) as fields:
        loss = float(make_gimm_train_step()(state, batch)["loss_total"])
    return {"loss": loss, **fields,
            "grads": {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
            "state": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}


def hold_stage1_step(ref: dict, got: dict, where: str) -> tuple[float, float, str, list]:
    """Phase 11 (c)'s bounds on one stage-1 step `got` against `ref`
    (`step_fields` readings): the loss to 1e-5 relative; each gradient to
    1e-4 x max|g_ref| but those of `ALPHAS`; the fields u and c to 1e-4 x
    max|ref|; each alpha's gradient within a float32 dot product's rounding
    of its own fields' contraction on both sides, and to 1e-4 x S (S =
    sum_p |u_p c_p| of `ref`). Returns (loss gap, largest gradient gap, its
    tensor, the alphas' readings); raises on a miss."""
    rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    if not rel <= 1e-5:
        raise AssertionError(f"{where}: loss {got['loss']} vs {ref['loss']} ({rel:.2e})")
    worst, worst_name, readings = 0.0, None, []
    for name, g_ref in ref["grads"].items():
        gap = float((got["grads"][name] - g_ref).abs().max()) / float(g_ref.abs().max())
        if name not in ALPHAS and not gap <= 1e-4:
            raise AssertionError(f"{where}: the gradient of {name} is {gap:.3e} x max|g_ref| off")
        if name not in ALPHAS and gap > worst:
            worst, worst_name = gap, name
    for field in ("u", *ALPHAS):
        gap = float((got[field] - ref[field]).abs().max() / ref[field].abs().max())
        if not gap <= 1e-4:
            raise AssertionError(f"{where}: the field {field} is {gap:.3e} x max|ref| off")
    for name in ALPHAS:
        terms = {"ref": ref["u"] * ref[name], "got": got["u"] * got[name]}
        sums = {d: float(t.abs().sum()) for d, t in terms.items()}
        for d, r in (("ref", ref), ("got", got)):
            off = abs(float(r["grads"][name]) - float(terms[d].sum()))
            if not off <= (math.log2(terms[d].numel()) + 4) * 2**-24 * sums[d]:
                raise AssertionError(f"{where}: {d} gradient of {name} is {off:.3e} off "
                                     f"its fields' contraction (S {sums[d]:.3e})")
        g_ref = float(ref["grads"][name])
        gap = abs(float(got["grads"][name]) - g_ref)
        if not gap <= 1e-4 * sums["ref"]:
            raise AssertionError(f"{where}: the gradient of {name} is {gap:.3e} off "
                                 f"(1e-4 x S = {1e-4 * sums['ref']:.3e})")
        readings.append({"tensor": name, "gap_over_S": gap / sums["ref"],
                         "gap_over_itself": gap / abs(g_ref),
                         "S_over_itself": sums["ref"] / abs(g_ref)})
    return rel, worst, worst_name, readings


def check_step_gpu_vs_cpu() -> dict:
    """Phase 11 (c): one recipe step of GIMM at 64x64, batch 2 (t_id 1 and
    2), on the card and on the CPU from the same seeded weights and batch,
    for each of `GRAD_SEEDS`, `GPU_RERUNS` times on the card. The loss
    agrees to 1e-5 relative, and each gradient tensor to 1e-4 x max|g_cpu|,
    but those of `ALPHAS`. Each of these is one sum over every pixel,
    sum_p u_p c_p (`step_fields`), that nearly cancels (the normalised
    splat hardly changes when its weights scale together): float32 holds
    such a sum only relative to the size of its terms, S = sum_p |u_p c_p|,
    not to its own. So the fields u and c are held to 1e-4 x max|cpu| as
    the gradients are; on each device the alpha's gradient is the float64
    contraction of its own fields, within a float32 dot product's rounding
    ((log2 n + 4) x 2^-24 x S, n terms); and GPU vs CPU it agrees to 1e-4 x
    S. Its gap relative to itself is printed beside, with S / |g|
    (`hold_stage1_step`)."""
    cfg = load_config(RECIPE)
    loss_rel, worst, worst_name, readings = 0.0, 0.0, None, []
    for seed in GRAD_SEEDS:
        weights, batch = stage1_inputs(seed)
        cpu = step_fields(cfg, "cpu", weights, batch)
        for run in range(GPU_RERUNS):
            gpu = step_fields(cfg, "cuda", weights, batch)
            rel, gap, name, alphas = hold_stage1_step(cpu, gpu, f"[11] (c) seed {seed} run {run}")
            loss_rel = max(loss_rel, rel)
            if gap > worst:
                worst, worst_name = gap, name
            readings += [{"seed": seed, "run": run, **a} for a in alphas]
    print(f"[11] (c) one step at 64x64, batch 2, GPU vs CPU, seeds {list(GRAD_SEEDS)} x "
          f"{GPU_RERUNS} runs on the card: loss within {loss_rel:.2e} relative; largest gradient "
          f"gap {worst:.2e} x max|g_cpu| ({worst_name}); {', '.join(ALPHAS)}: "
          f"{json.dumps(readings)}", flush=True)
    return {"loss_rel": loss_rel, "grad_rel": worst, "alpha_readings": readings}


def stage1_inputs(seed: int) -> tuple[dict, dict]:
    """Phase 11 (c)'s seeded GIMM weights and batch of 2 at 64x64 (t_id 1, 2)."""
    torch.manual_seed(seed)
    weights = GIMM(device="cpu").state_dict()
    batch = flow_batch(2, (64, 64), seed + 12, device="cpu")
    batch["t_id"] = np.asarray([1, 2], np.int32)
    return weights, batch


def flow_tree(root: Path, n_seq: int, hw, seed: int):
    """A Vimeo-like flow tree: `n_seq` sequences of 4 `.flo` fields at
    `hw`, linked to 8 seeded smooth fields a name, listed for both splits."""
    rng = np.random.default_rng(seed)
    names = ("im1_im3", "im2_im3", "im2_im1", "im3_im1")
    distinct = root / "distinct"
    distinct.mkdir(parents=True)
    for name in names:
        for k in range(8):
            _, flow = seeded_flows(hw, int(rng.integers(1 << 30)))
            write_flo(str(distinct / f"{name}_{k}.flo"), flow[0, 0].numpy())
    seqs = [f"00001/{i:04d}" for i in range(n_seq)]
    for i, seq in enumerate(seqs):
        d = root / "flow_sequences" / seq
        d.mkdir(parents=True)
        for name in names:
            os.symlink(distinct / f"{name}_{i % 8}.flo", d / f"{name}.flo")
    for listing in ("tri_trainlist.txt", "tri_testlist.txt"):
        (root / listing).write_text("\n".join(seqs) + "\n")


def run_train_cli(smi: str) -> dict:
    """Phase 11 (d): `cli/train.py` on the card with the recipe's config and
    `--smoke-test` on a fabricated tree of 256x448 `.flo` triplets (Vimeo's
    frame size): one epoch (2 steps of 32 at the 256^2 crop, validation at
    256x448, a checkpoint), then `--resume` for a second; exact splat
    launches; steps run, seconds an epoch, and which writer it found."""
    cfg = load_config(RECIPE)
    n = cfg.experiment.batch_size
    root = WORK11 / "vimeo_triplet"
    flow_tree(root, 2 * n, GIMM_HW, SEED + 13)
    runs = WORK11 / "runs"
    argv = ["--config", RECIPE, "--result-path", str(runs), "--overrides",
            f"dataset.path={root}", "experiment.epochs=1", "--smoke-test"]
    out = []
    for label, args in (("first epoch", argv),
                        ("--resume", None)):
        if args is None:
            args = ["--config", RECIPE, "--result-path", out[0]["run_dir"], "--resume",
                    "--overrides", "experiment.epochs=2", "--smoke-test"]
        reset_counts()
        t0 = time.perf_counter()
        res = train_cli.main(args)
        seconds = time.perf_counter() - t0
        got = counts()
        # an epoch: 2 steps (2 forward and 2 backward splats each) and 2
        # validation batches (2 forward splats each)
        expect_counts(f"(d) train CLI, {label}", got, 8, splat_bwd=4, phase=11)
        epoch = res["epochs"][-1]
        numbers = [*epoch["train"].values(), *epoch["valid"].values()]
        if not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"[11] (d) {label}: {epoch}")
        print(f"[11] (d) train CLI {label}: {res['steps']} steps run in all, epoch "
              f"{epoch['epoch']} {epoch['seconds']:.2f} s, the call {seconds:.2f} s; train "
              f"{json.dumps(epoch['train'])}; valid {json.dumps(epoch['valid'])}; launches {got}; "
              f"writer {res['writer']}; {smi}", flush=True)
        out.append({**res, "seconds": seconds, "launches": got})
    log = (Path(out[0]["run_dir"]) / "train.log").read_text()
    ckpts = sorted(os.listdir(Path(out[0]["run_dir"]) / "ckpt"))
    if not (out[0]["steps"] == 2 and out[1]["steps"] == 4 and "resumed from step 2" in log
            and ckpts == ["step_2.pt", "step_4.pt"]):
        raise AssertionError(f"[11] (d) steps {out[0]['steps']}, {out[1]['steps']}; "
                             f"checkpoints {ckpts}")
    return {"steps": out[1]["steps"], "epoch_seconds": [o["epochs"][-1]["seconds"] for o in out],
            "call_seconds": [o["seconds"] for o in out], "run_dir": out[0]["run_dir"],
            "writer": out[0]["writer"], "launches": out[0]["launches"]}


def run_phase11(smi: str) -> dict:
    """Phase 11: stage-1 GIMM training on the card, float32, TF32 off."""
    shutil.rmtree(WORK11, ignore_errors=True)
    WORK11.mkdir(parents=True)
    t0 = time.perf_counter()
    res = {"backward": check_backward(), "step": run_recipe_step(smi),
           "gpu_vs_cpu": check_step_gpu_vs_cpu(), "cli": run_train_cli(smi)}
    print(f"[11] phase 11 took {time.perf_counter() - t0:.2f} s", flush=True)
    return res


# ------------------------------------------------------------------ phase 12
WORK12 = Path(__file__).resolve().parent / "build" / "chip_smoke_phase12"
RECIPE2 = "configs/gimmvfi/gimmvfi_r_arb.yaml"  # stage 2: AdamW lr 8e-5, ft groups, batch 4
RECIPE2_F = "configs/gimmvfi/gimmvfi_f_arb.yaml"
CROP2 = 224  # VimeoArbitrary's crop
STEP_SPLATS = 6  # 3 decodes a step (t = 0, t = 1, t) x 2 latent splats
# the biases of the convs that feed a normalization (RAFT's encoders, the
# decoder heads' 1x1 projection): zero in exact arithmetic (ROADMAP C3)
PRE_NORM_BIAS = re.compile(r"flow_estimator\.(fnet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))"
                           r"\.bias|amt_init_decoder\.upsample\.6\.bias|amt_final_decoder\.upsample\.7\.bias")


def vfi_batch(n: int, hw, seed: int, device="cuda") -> dict:
    """A stage-2 batch from one seeded smooth image: img0, gt and img1 are
    crops of it shifted by (2, 3) pixels a frame, t = k/6 for sample k
    (1..n), the loss's subsample of int(H*W*0.1) pixels a sample."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h, w = hw
    coarse = torch.rand((n, 3, h // 8 + 2, w // 8 + 2), generator=gen)
    base = torch.nn.functional.interpolate(coarse, size=(h + 8, w + 8), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)
    rng = np.random.default_rng(seed)
    k = int(h * w * 0.1)
    sub = [torch.from_numpy(np.stack([rng.permutation(h * w)[:k] for _ in range(n)]))
           for _ in range(2)]
    batch = {"img0": base[:, 0:h, 0:w], "gt": base[:, 2:h + 2, 3:w + 3],
             "img1": base[:, 4:h + 4, 6:w + 6],
             "t": torch.arange(1, n + 1, dtype=torch.float32) / 6.0,
             "sub_idx0": sub[0], "sub_idx1": sub[1]}
    return {key: v.contiguous().to(device) for key, v in batch.items()}


def vfi_state(cfg, family=GIMMVFI_R, device=None, seed=SEED, **model_kw):
    """A stage-2 model from a seed (its own initialization; remat on, its
    default and the train CLI's, unless `model_kw` says) and the recipe's
    optimizer (AdamW with the ft groups) and EMA."""
    torch.manual_seed(seed)
    model = family(device=device, **model_kw)
    o = cfg.optimizer
    opt, sched = create_optimizer(model, o.type, init_lr=o.init_lr, weight_decay=o.weight_decay,
                                  betas=tuple(o.betas), ft=o.ft, max_grad_norm=o.max_gn)
    return create_train_state(model, opt, sched, use_ema=bool(cfg.arch.ema))


def run_stage2_step(smi: str, config: str, family, label: str, timed_steps: int,
                    lpips_path: Path, trace: bool, phase: int = 12, **model_kw) -> dict:
    """One recipe step of stage 2 on the card, float32, TF32 off, batch 4 at
    224^2, with the perceptual loss the recipe sets (`lpips_path`, loaded as
    the train CLI loads it): counted from 0 (exactly 6 forward and 6
    backward splat launches, no windowed lookup), 1 more warm-up, then
    `timed_steps` timed by CUDA events (median ms, peak allocated); the loss
    and its LPIPS term finite and nonzero, the parameters of both optimizer
    groups, the BatchNorm running statistics and the EMA moved; then, with
    `trace`, the device time of one step and of its splats and NCCL rows in
    a trace. Phase 13 (a) runs it under a process group."""
    cfg = load_config(config)
    n = cfg.experiment.batch_size
    state = vfi_state(cfg, family, **model_kw)
    if not cfg.loss.perceptual_loss:
        raise AssertionError(f"[{phase}] ({label}) {config} sets no perceptual loss")
    lpips_fn = train_cli.lpips_loss_fn(str(lpips_path), torch.device("cuda"))
    step = make_gimmvfi_train_step(cfg.arch.rec_weight, lpips_fn, use_ema=bool(cfg.arch.ema))
    batch = vfi_batch(n, (CROP2, CROP2), SEED + 21)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    ema_before = {k: v.clone() for k, v in state.ema.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step(state, batch)
    torch.cuda.synchronize()
    got = counts()
    expect_counts(f"({label}) the recipe step", got, STEP_SPLATS, splat_bwd=STEP_SPLATS, phase=phase)
    step(state, batch)
    times, losses, perceptual = [], [], []
    for _ in range(timed_steps):
        metrics, ms = bench.timed(lambda: step(state, batch), torch.device("cuda"))
        times.append(ms)
        losses.append(float(metrics["loss_total"]))
        perceptual.append(float(metrics["lpips"]))
    peak = torch.cuda.max_memory_allocated()
    after = state.model.state_dict()
    moved = {"amt": 0.0, "rest": 0.0, "running_stats": 0.0}
    for k, v in after.items():
        d = float((v.float() - before[k].float()).abs().max())
        group = ("running_stats" if "running_" in k
                 else "amt" if any(p.startswith("amt_") for p in k.split(".")) else "rest")
        moved[group] = max(moved[group], d)
    moved["ema"] = max(float((v - ema_before[k]).abs().max()) for k, v in state.ema.items())
    if not (all(math.isfinite(x) for x in losses + perceptual) and all(perceptual)
            and min(moved.values()) > 0):
        raise AssertionError(f"[{phase}] ({label}) losses {losses}, LPIPS terms {perceptual}, "
                             f"largest moves {moved}")
    step_dev, rows = (device_ms(lambda: step(state, batch), iters=1, warmup=0) if trace
                      else (None, {}))
    fwd = sorted_rows(rows)
    bwd = kernel_row(rows, "splat_sum_bwd_kernel")
    med = statistics.median(times)
    nccl = {k: v for k, v in rows.items() if "nccl" in k.lower()}
    splat_dev = None if fwd is None or bwd is None else fwd + bwd
    print(f"[{phase}] ({label}) the recipe step ({config}: {family.__name__}, {cfg.optimizer.type} lr "
          f"{cfg.optimizer.init_lr}, ft groups, EMA, the perceptual loss, batch {n}, "
          f"{CROP2}x{CROP2}, float32): "
          f"{med:.2f} ms a step (median of {timed_steps} by events; {min(times):.2f}-"
          f"{max(times):.2f}); peak allocated {peak / 2**20:.1f} MiB; launches a step {got}; "
          f"losses {losses[0]:.5f} -> {losses[-1]:.5f} (LPIPS terms {perceptual[0]:.5f} -> "
          f"{perceptual[-1]:.5f}); largest moves {json.dumps(moved)}; device "
          f"time of one traced step {fmt_ms(step_dev)}; its splats: forward {fmt_ms(fwd)}, "
          f"backward {fmt_ms(bwd)} ({STEP_SPLATS} launches each), "
          f"{'not measured' if splat_dev is None else f'{100 * splat_dev / med:.2f}%'} of the "
          f"step; {smi}", flush=True)
    if trace:
        top = sorted(rows.items(), key=lambda kv: -kv[1])[:8]
        print(f"[{phase}] ({label}) the step's largest device rows: "
              f"{'; '.join(f'{v:.3f} ms {k[:70]}' for k, v in top)}", flush=True)
    res = {"step_ms": med, "step_ms_all": times, "peak_bytes": peak, "launches": got,
           "losses": losses, "moved": moved, "step_device_ms": step_dev,
           "splat_fwd_device_ms": fwd, "splat_bwd_device_ms": bwd, "nccl_device_ms": nccl}
    del state, batch
    gc.collect()  # the optimizer and its schedule's hook hold each other
    torch.cuda.empty_cache()
    return res


def vfi_step_fields(cfg, device: str, weights: dict, batch: dict, raft_iters: int = 2,
                    lpips_fn=None, **model_kw) -> dict:
    """One stage-2 step of GIMMVFI_R(raft_iters, **model_kw) from `weights`
    (with `lpips_fn` as its perceptual loss): the loss, each parameter's
    gradient (on the CPU), the BatchNorm running statistics after it, the
    fields u and c of the alphas' gradients (`alpha_fields`) and the state
    dict after the step (on the CPU)."""
    state = vfi_state(cfg, device=device, raft_iters=raft_iters, **model_kw)
    state.model.load_state_dict(weights)
    batch = {k: v.to(device) for k, v in batch.items()}
    with alpha_fields(gimmvfi_r_model) as fields:
        loss = float(make_gimmvfi_train_step(cfg.arch.rec_weight, lpips_fn, use_ema=False)(
            state, batch)["loss_total"])
    after = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    return {"loss": loss, **fields,
            "grads": {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
            "stats": {k: v for k, v in after.items() if "running_" in k}, "state": after}


def stage2_readings() -> dict:
    return {"loss_rel": 0.0, "stats_rel": 0.0, "grad_rel_l2": 0.0, "grad_rel_l2_name": None,
            "field_rel_l2": 0.0, "within_1e-4_max": [], "alphas": []}


def hold_stage2_step(ref: dict, got: dict, where: str, readings: dict, seed: int):
    """Phase 12 (b)'s bounds on one stage-2 step `got` against `ref`
    (`vfi_step_fields` readings): the loss to 1e-5 relative; the running
    statistics to 1e-5 x max(1, max|ref|); each gradient within 1e-2
    relative L2, but the biases that feed a normalization (within 1e-2 x
    max|g| of their weights on both sides) and `ALPHAS` (within 1e-4 x S of
    `ref`), their fields u and c within 5e-2 relative L2. Updates
    `readings` (`stage2_readings`); raises on a miss."""
    rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    if not rel <= 1e-5:
        raise AssertionError(f"{where}: loss {got['loss']} vs {ref['loss']} ({rel:.2e})")
    readings["loss_rel"] = max(readings["loss_rel"], rel)
    for k, v in ref["stats"].items():
        gap = float((got["stats"][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
        if not gap <= 1e-5:
            raise AssertionError(f"{where}: running statistic {k} is {gap:.3e} off")
        readings["stats_rel"] = max(readings["stats_rel"], gap)
    within = 0
    for name, gr in ref["grads"].items():
        gg = got["grads"][name]
        within += float((gg - gr).abs().max()) <= 1e-4 * float(gr.abs().max())
        if name in ALPHAS:
            continue
        if PRE_NORM_BIAS.fullmatch(name):
            w_scale = float(ref["grads"][name[:-len("bias")] + "weight"].abs().max())
            if not all(float(g.abs().max()) <= 1e-2 * w_scale for g in (gg, gr)):
                raise AssertionError(f"{where}: {name}, zero in exact arithmetic, is over "
                                     f"1e-2 x {w_scale:.3e}")
            continue
        gap = float((gg - gr).double().norm() / gr.double().norm())
        if not gap <= 1e-2:
            raise AssertionError(f"{where}: the gradient of {name} is {gap:.3e} off in "
                                 f"relative L2")
        if gap > readings["grad_rel_l2"]:
            readings["grad_rel_l2"], readings["grad_rel_l2_name"] = gap, name
    readings["within_1e-4_max"].append(f"{within}/{len(ref['grads'])}")
    for field in ("u", *ALPHAS):
        gap = float((got[field] - ref[field]).norm() / ref[field].norm())
        if not gap <= 5e-2:
            raise AssertionError(f"{where}: the field {field} is {gap:.3e} off in relative L2")
        readings["field_rel_l2"] = max(readings["field_rel_l2"], gap)
    for name in ALPHAS:
        s_abs = float((ref["u"] * ref[name]).abs().sum())
        g_ref = float(ref["grads"][name])
        gap = abs(float(got["grads"][name]) - g_ref)
        if not gap <= 1e-4 * s_abs:
            raise AssertionError(f"{where}: the gradient of {name} is {gap:.3e} off "
                                 f"(1e-4 x S = {1e-4 * s_abs:.3e})")
        readings["alphas"].append({"seed": seed, "tensor": name, "gap_over_S": gap / s_abs,
                                   "gap_over_itself": gap / abs(g_ref),
                                   "S_over_itself": s_abs / abs(g_ref)})


def stage2_inputs(seed: int) -> tuple[dict, dict]:
    """Phase 12 (b)'s seeded GIMMVFI_R(raft_iters=2) weights and batch of 2 at 128x128."""
    torch.manual_seed(seed)
    weights = GIMMVFI_R(raft_iters=2, device="cpu").state_dict()
    return weights, vfi_batch(2, (128, 128), seed + 22, device="cpu")


def check_vfi_step_gpu_vs_cpu() -> dict:
    """Phase 12 (b): one stage-2 step of GIMMVFI_R(raft_iters=2) at 128x128,
    batch 2, on the card and on the CPU from the same seeded weights and
    batch, for 2 seeds: the loss <= 1e-5 relative; the BatchNorm running
    statistics after it <= 1e-5 x max(1, max|cpu|); the gradients as
    ROADMAP C3 holds stage 2's (each tensor within 1e-2 of the CPU's in
    relative L2, 4x the largest gap read, 2.55e-3; the biases that feed a
    normalization, zero in exact arithmetic, within 1e-2 x max|g| of their
    weights; `alpha_v` and `alpha_fe` within 1e-4 x the sum of their terms'
    magnitudes S, their fields u and c within 5e-2 relative L2, the largest
    gap printed; `hold_stage2_step`). The share of tensors within stage 1's
    1e-4 x max|g_cpu| is printed beside."""
    cfg = load_config(RECIPE2)
    readings = stage2_readings()
    for seed in (SEED, SEED + 1):
        weights, batch = stage2_inputs(seed)
        cpu = vfi_step_fields(cfg, "cpu", weights, batch)
        gpu = vfi_step_fields(cfg, "cuda", weights, batch)
        hold_stage2_step(cpu, gpu, f"[12] (b) seed {seed}", readings, seed)
    print(f"[12] (b) one stage-2 step at 128x128, batch 2, GPU vs CPU, seeds {SEED}, {SEED + 1}: "
          f"{fmt_stage2(readings)}", flush=True)
    return readings


def check_wide_radius_step() -> dict:
    """Phase 12 (f): one stage-2 step of GIMMVFI_R(raft_iters=2,
    corr_radius=5, corr_max_volume_bytes=0) at 128x128, batch 2, on the card
    and on the CPU from the same seeded weights and batch: RAFT's 2 x 2
    lookups (radius 4) and their backwards on the fast cases, the AMT's 2
    (radius 5) on the 3xTF32 kernel's general case and the backward's,
    counted exactly; (b)'s bounds (`hold_stage2_step`)."""
    cfg = load_config(RECIPE2)
    kw = {"corr_radius": 5, "corr_max_volume_bytes": 0}
    torch.manual_seed(SEED + 26)
    weights = GIMMVFI_R(raft_iters=2, device="cpu", **kw).state_dict()
    batch = vfi_batch(2, (128, 128), SEED + 27, device="cpu")
    cpu = vfi_step_fields(cfg, "cpu", weights, batch, **kw)
    reset_counts()
    gpu = vfi_step_fields(cfg, "cuda", weights, batch, **kw)
    got = counts()
    expect_counts("(f) the radius-5 windowed step", got, STEP_SPLATS, tf32=4, splat_bwd=STEP_SPLATS,
                  phase=12, corr_bwd=4, tf32_general=2, corr_bwd_general=2)
    readings = stage2_readings()
    hold_stage2_step(cpu, gpu, "[12] (f) radius 5 windowed", readings, SEED + 26)
    print(f"[12] (f) one stage-2 step of GIMMVFI_R(raft_iters=2, corr_radius=5, "
          f"corr_max_volume_bytes=0) at 128x128, batch 2, GPU vs CPU: launches {got}; "
          f"{fmt_stage2(readings)}", flush=True)
    del cpu, gpu, weights, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, **readings}


def run_windowed_step(smi: str, lpips_path: Path, p12_step: dict) -> dict:
    """Phase 12 (e): (a)'s recipe step with `corr_max_volume_bytes=0`, so
    that RAFT's lookups and the AMT's go to the float32 windowed kernel and
    its backward: exact launches counted from 0 (RAFT's lookups, one a
    direction a call, twice `raft_iter`, and the AMT's 2; as many
    backwards; 6 + 6 splats; no bf16 or CUDA-core lookup); a finite loss; the
    events median of `TIMED_STEPS` after a warm-up beside (a)'s, the peak,
    the device time of one traced step and of its lookups' rows; (a) the
    backward kernel's readings (`bwd_reading`) on the step's AMT lookup,
    captured; then, from the same seeded weights and batch of 4 at 224^2,
    the windowed step's gradients against the default (materialized)
    step's on the card, both with the perceptual loss, under (b)'s bounds
    (`hold_stage2_step`: ROADMAP C3's stage-2 bounds)."""
    cfg = load_config(RECIPE2)
    n, iters = cfg.experiment.batch_size, cfg.arch.raft_iter
    lookups = 2 * iters + 2
    state = vfi_state(cfg, raft_iters=iters, corr_max_volume_bytes=0)
    lpips_fn = train_cli.lpips_loss_fn(str(lpips_path), torch.device("cuda"))
    step = make_gimmvfi_train_step(cfg.arch.rec_weight, lpips_fn, use_ema=bool(cfg.arch.ema))
    batch = vfi_batch(n, (CROP2, CROP2), SEED + 21)
    recorder = BwdRecorder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    corr_ops.WINDOWED_CORR_BWD_KERNEL = recorder
    try:
        metrics = step(state, batch)
    finally:
        corr_ops.WINDOWED_CORR_BWD_KERNEL = WINDOWED_CORR_BWD_KERNEL
    torch.cuda.synchronize()
    got = counts()
    expect_counts("(e) the windowed recipe step", got, STEP_SPLATS, tf32=lookups,
                  splat_bwd=STEP_SPLATS, phase=12, corr_bwd=lookups)
    if recorder.calls != lookups or len(recorder.inputs) != 2:
        raise AssertionError(f"[12] (e) {recorder.calls} backward calls, {len(recorder.inputs)} "
                             f"asking for d_coords; expected {lookups} and the AMT's 2")
    losses = [float(metrics["loss_total"])]
    step(state, batch)
    times = []
    for _ in range(TIMED_STEPS):
        metrics, ms = bench.timed(lambda: step(state, batch), torch.device("cuda"))
        times.append(ms)
        losses.append(float(metrics["loss_total"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[12] (e) losses {losses}")
    step_dev, rows = device_ms(lambda: step(state, batch), iters=1, warmup=0)
    # the backward's own kernels (its sorts share their rows with the splat's)
    own = [v for k, v in rows.items() if "windowed_corr_bwd_" in k]
    bwd_dev = sum(own) if own else None
    fwd_dev = kernel_row(rows, "windowed_corr_tf32_kernel")
    med = statistics.median(times)
    print(f"[12] (e) the recipe step with corr_max_volume_bytes=0 (RAFT's and the AMT's "
          f"correlation windowed, float32): launches {got} (RAFT's {2 * iters} lookups, one a "
          f"direction a call, and the AMT's 2, each with its backward); {med:.2f} ms a step "
          f"(median of {TIMED_STEPS} by events; {min(times):.2f}-{max(times):.2f}) against (a)'s "
          f"{p12_step['step_ms']:.2f}; peak allocated {peak / 2**20:.1f} MiB against (a)'s "
          f"{p12_step['peak_bytes'] / 2**20:.1f}; losses {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"device time of one traced step {fmt_ms(step_dev)}, its {lookups} lookups "
          f"{fmt_ms(fwd_dev)} and their backwards {fmt_ms(bwd_dev)} (the backward's own kernels; "
          f"its sorts' rows are the splat's too); {smi}", flush=True)
    res = {"step_ms": med, "step_ms_all": times, "peak_bytes": peak, "launches": got,
           "losses": losses, "step_device_ms": step_dev, "lookup_device_ms": fwd_dev,
           "bwd_device_ms": bwd_dev}
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    wc, coords, g, radius = recorder.inputs[0]
    res["a"] = bwd_reading(wc, coords, g, "[12] (e) (a) windowed backward at the stage-2 AMT "
                           "lookup (captured from the step)", smi, True, radius)
    del recorder, wc, coords, g
    torch.cuda.empty_cache()

    torch.manual_seed(SEED + 24)
    weights = GIMMVFI_R(raft_iters=iters, device="cpu").state_dict()
    batch = vfi_batch(n, (CROP2, CROP2), SEED + 25, device="cpu")
    readings = stage2_readings()
    ref = vfi_step_fields(cfg, "cuda", weights, batch, iters, lpips_fn)
    reset_counts()
    got_fields = vfi_step_fields(cfg, "cuda", weights, batch, iters, lpips_fn,
                                 corr_max_volume_bytes=0)
    if WINDOWED_CORR_BWD_KERNEL.launches != lookups:
        raise AssertionError(f"[12] (e) the windowed step made {WINDOWED_CORR_BWD_KERNEL.launches} "
                             f"backward launches, expected {lookups}")
    hold_stage2_step(ref, got_fields, "[12] (e) windowed vs materialized", readings, SEED + 24)
    print(f"[12] (e) the recipe step (batch {n}, {CROP2}x{CROP2}, raft_iters {iters}, the "
          f"perceptual loss) windowed against materialized on the card, same weights and batch: "
          f"{fmt_stage2(readings)}", flush=True)
    res["vs_materialized"] = readings
    del ref, got_fields, weights, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def fmt_stage2(readings: dict) -> str:
    return (f"loss within {readings['loss_rel']:.2e} relative; running statistics within "
            f"{readings['stats_rel']:.2e}; largest gradient gap {readings['grad_rel_l2']:.2e} "
            f"relative L2 ({readings['grad_rel_l2_name']}); the alphas' fields u, c within "
            f"{readings['field_rel_l2']:.2e} relative L2; tensors within 1e-4 x max|g_ref| "
            f"{readings['within_1e-4_max']}; alphas {json.dumps(readings['alphas'])}")


def vimeo_tree(root: Path, n_seq: int, hw, seed: int) -> str:
    """A Vimeo tree in the recipe's layout, PNGs written with cv2:
    `vimeo_septuplet` (7 frames a sequence, `all_sep.txt`) and
    `vimeo_triplet` (3 frames, `tri_testlist.txt`, whose last line the test
    split drops); the frames are shifted crops of seeded smooth images.
    Returns the septuplet root."""
    import cv2

    seqs = [f"00001/{i:04d}" for i in range(n_seq)]
    for split, frames, listing, extra in (("vimeo_septuplet", 7, "all_sep.txt", []),
                                          ("vimeo_triplet", 3, "tri_testlist.txt", ["dummy_last"])):
        for i, s in enumerate(seqs):
            d = root / split / "sequences" / s
            d.mkdir(parents=True)
            img = vfi_batch(1, (hw[0] + 16, hw[1] + 16), seed + i, device="cpu")["img0"][0]
            img = (img.numpy() * 255).astype(np.uint8)
            for k in range(frames):
                cv2.imwrite(str(d / f"im{k + 1}.png"), img[2 * k:2 * k + hw[0], k:k + hw[1], ::-1])
        (root / split / listing).write_text("\n".join(seqs + extra) + "\n")
    return str(root / "vimeo_septuplet")


def run_stage2_cli(smi: str, stage1_ckpt: str, lpips_path: Path) -> dict:
    """Phase 12 (c): `cli/train.py` on the card with the stage-2 recipe and
    `--smoke-test` on a fabricated tree of 8 septuplets of 256x448 PNGs
    (written with cv2), `--load-path` phase 11's stage-1 checkpoint and
    `--lpips-path` a seeded LPIPS `.pt`: one epoch (2 steps of 4 at the
    224^2 crop, validation and EMA validation at 256x448, the
    reconstruction grid, a checkpoint), then `--resume` for a second; exact
    launches, steps, seconds an epoch, and whether Pillow was found."""
    cfg = load_config(RECIPE2)
    n = cfg.experiment.batch_size
    sep = vimeo_tree(WORK12 / "data", 2 * n, GIMM_HW, SEED + 23)
    runs = WORK12 / "runs"
    common = ["--lpips-path", str(lpips_path), "--smoke-test", "--overrides",
              "experiment.test_imlog_freq=1"]
    out = []
    for label in ("first epoch", "--resume"):
        if label == "first epoch":
            args = ["--config", RECIPE2, "--result-path", str(runs), "--load-path", stage1_ckpt,
                    *common, f"dataset.path={sep}", "experiment.epochs=1"]
        else:
            args = ["--config", RECIPE2, "--result-path", out[0]["run_dir"], "--resume",
                    *common, "experiment.epochs=2"]
        reset_counts()
        t0 = time.perf_counter()
        res = train_cli.main(args)
        seconds = time.perf_counter() - t0
        got = counts()
        # an epoch: 2 steps (6 forward and 6 backward splats each), 2
        # validation batches for each of the model and its EMA and the
        # reconstruction grid's batch (6 forward splats each)
        expect_counts(f"(c) train CLI, {label}", got, (2 + 2 * 2 + 1) * STEP_SPLATS,
                      splat_bwd=2 * STEP_SPLATS, phase=12)
        epoch = res["epochs"][-1]
        numbers = [*epoch["train"].values(), *epoch["valid"].values(), *epoch["valid_ema"].values()]
        if not (all(math.isfinite(v) for v in numbers) and epoch["train"]["lpips"] != 0):
            raise AssertionError(f"[12] (c) {label}: {epoch}")
        print(f"[12] (c) train CLI {label}: {res['steps']} steps run in all, epoch "
              f"{epoch['epoch']} {epoch['seconds']:.2f} s, the call {seconds:.2f} s; train "
              f"{json.dumps(epoch['train'])}; valid {json.dumps(epoch['valid'])}; launches {got}; "
              f"{smi}", flush=True)
        out.append({**res, "seconds": seconds, "launches": got})
    log = (Path(out[0]["run_dir"]) / "train.log").read_text()
    ckpts = sorted(os.listdir(Path(out[0]["run_dir"]) / "ckpt"))
    n_gimm = len(GIMM(device="cpu").state_dict())
    if not (out[0]["steps"] == 2 and out[1]["steps"] == 4 and "resumed from step 2" in log
            and ckpts == ["step_2.pt", "step_4.pt"]
            and f"partially loaded weights from {stage1_ckpt} ({n_gimm} tensors)" in log):
        raise AssertionError(f"[12] (c) steps {out[0]['steps']}, {out[1]['steps']}; "
                             f"checkpoints {ckpts}; the load line missing from {log[:2000]}")
    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    print(f"[12] (c) Pillow {pillow or 'not found'} (PNGs read with "
          f"{'Pillow' if pillow else 'cv2'}); writer {out[0]['writer']}", flush=True)
    return {"steps": out[1]["steps"], "epoch_seconds": [o["epochs"][-1]["seconds"] for o in out],
            "call_seconds": [o["seconds"] for o in out], "pillow": pillow,
            "launches": out[0]["launches"], "epoch0": out[0]["epochs"][0], "data": sep}


def run_phase12(smi: str, stage1_ckpt: str) -> dict:
    """Phase 12: stage-2 GIMM-VFI training on the card, float32, TF32 off."""
    shutil.rmtree(WORK12, ignore_errors=True)
    WORK12.mkdir(parents=True)
    lpips_path = WORK12 / "lpips_seeded.pt"  # the perceptual loss of (a), (c), (d)
    torch.manual_seed(SEED)
    torch.save(LPIPS(device="cpu").state_dict(), lpips_path)
    parts = {"step": lambda: run_stage2_step(smi, RECIPE2, GIMMVFI_R, "a", TIMED_STEPS, lpips_path,
                                             True, raft_iters=load_config(RECIPE2).arch.raft_iter),
             "gpu_vs_cpu": check_vfi_step_gpu_vs_cpu,
             "wide_radius_step": check_wide_radius_step,
             "cli": lambda: run_stage2_cli(smi, stage1_ckpt, lpips_path),
             "f_step": lambda: run_stage2_step(smi, RECIPE2_F, GIMMVFI_F, "d", 3, lpips_path, False)}
    res, seconds = {}, {}
    parts["windowed_step"] = lambda: run_windowed_step(smi, lpips_path, res["step"])
    for name, part in parts.items():
        t0 = time.perf_counter()
        res[name] = part()
        seconds[name] = time.perf_counter() - t0
    print(f"[12] phase 12 took {sum(seconds.values()):.2f} s "
          f"({', '.join(f'{k} {v:.2f}' for k, v in seconds.items())})", flush=True)
    return res


# ------------------------------------------------------------------ phase 13
WORK13 = Path(__file__).resolve().parent / "build" / "chip_smoke_phase13"
DP_WORLD = 2  # gloo ranks on the one card in (b)


def run_dp_step(smi: str, lpips_path: Path, p12_step: dict) -> dict:
    """Phase 13 (a): phase 12 (a)'s recipe step through the data-parallel
    step, under a process group of one NCCL rank on the card: the gradient's
    flat all-reduce and the metrics' mean run, BatchNorm keeps its own
    statistics (one rank). Exact splat launches, the events median beside
    phase 12 (a)'s, the peak, and the device time of one traced step with
    its NCCL rows."""
    gc.collect()
    before = torch.cuda.memory_allocated()
    dist_ops.init(torch.device("cuda", 0), "nccl", rank=0, world=1, local_rank=0, local_world=1,
                  init_method=f"file://{WORK13 / 'rendezvous_a'}")
    group_bytes = torch.cuda.memory_allocated() - before
    try:
        res = run_stage2_step(smi, RECIPE2, GIMMVFI_R, "a", TIMED_STEPS, lpips_path, True,
                              phase=13, raft_iters=load_config(RECIPE2).arch.raft_iter)
    finally:
        dist_ops.shutdown()
    nccl = res["nccl_device_ms"]
    res["group_bytes"] = group_bytes
    print(f"[13] (a) the data-parallel recipe step, one NCCL rank: {res['step_ms']:.2f} ms "
          f"(median of {TIMED_STEPS} by events) against phase 12 (a)'s {p12_step['step_ms']:.2f} "
          f"ms in this run ({min(p12_step['step_ms_all']):.2f}-{max(p12_step['step_ms_all']):.2f}); "
          f"device {fmt_ms(res['step_device_ms'])} against {fmt_ms(p12_step['step_device_ms'])}; "
          f"peak {res['peak_bytes'] / 2**20:.1f} MiB against {p12_step['peak_bytes'] / 2**20:.1f} "
          f"(the group's start allocated {group_bytes / 2**20:.1f} MiB); "
          f"NCCL rows of the traced step: "
          f"{'; '.join(f'{v:.4f} ms {k[:80]}' for k, v in nccl.items()) or 'none in the trace'}; "
          f"{smi}", flush=True)
    return res


def dp_rank_steps(stage1: tuple, stage2: tuple, out_dir: str):
    """One gloo rank of phase 13 (b): its row of each batch through a stage-1
    and a stage-2 step (`step_fields`, `vfi_step_fields`) on the card."""
    torch.backends.cudnn.allow_tf32 = False  # a spawned rank starts from torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    r = dist_ops.rank()
    row = lambda batch: {k: v[r:r + 1] for k, v in batch.items()}
    (w1, b1), (w2, b2) = stage1, stage2
    res = {"stage1": step_fields(load_config(RECIPE), "cuda", w1, row(b1)),
           "stage2": vfi_step_fields(load_config(RECIPE2), "cuda", w2, row(b2))}
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))


def dp_readings(ranks: list[dict]) -> dict:
    """The data-parallel step as one process would read it: rank 0's loss,
    gradients and state (checked bitwise equal on every rank), and the
    alphas' fields of all ranks in the batch's order. A rank's u is the
    gradient of the ranks' summed losses, world x the global mean's, so it
    is divided by the world."""
    world, first = len(ranks), ranks[0]
    for r, other in enumerate(ranks[1:], 1):
        for key in ("grads", "state"):
            for name, v in other[key].items():
                if not torch.equal(v, first[key][name]):
                    raise AssertionError(f"[13] (b) rank {r}'s {key} {name} differs from rank 0's")
        if other["loss"] != first["loss"]:
            raise AssertionError(f"[13] (b) rank {r}'s loss {other['loss']} != {first['loss']}")

    def batch_order(field, scale=1.0):
        # each rank's flat field is (w1, w2) of its sample: regroup as the
        # one-process field, (w1, w2) of the whole batch
        halves = [r[field].chunk(2) for r in ranks]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves]) * scale

    out = {k: v for k, v in first.items() if k not in ("u", *ALPHAS)}
    out["u"] = batch_order("u", 1.0 / world)
    out.update({a: batch_order(a) for a in ALPHAS})
    return out


def run_dp_ranks() -> dict:
    """Phase 13 (b): phase 11 (c)'s stage-1 step (GIMM at 64x64) and phase
    12 (b)'s stage-2 step (GIMMVFI_R(raft_iters=2) at 128x128), each on
    `DP_WORLD` gloo ranks on the card at batch 1 a rank (`spawn_ranks`)
    against one process at batch 2 on the card, from the same seeded
    weights and batch: held to phase 11 (c)'s and 12 (b)'s bounds
    (`hold_stage1_step`, `hold_stage2_step`), the ranks' parameters and
    buffers after the step bitwise equal."""
    stage1, stage2 = stage1_inputs(SEED), stage2_inputs(SEED)
    ref1 = step_fields(load_config(RECIPE), "cuda", *stage1)
    ref2 = vfi_step_fields(load_config(RECIPE2), "cuda", *stage2)
    out = WORK13 / "ranks"
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    dist_ops.spawn_ranks(dp_rank_steps, DP_WORLD, (stage1, stage2, str(out)), device="cuda:0",
                         backend="gloo", rendezvous=str(WORK13 / "rendezvous_b"))
    seconds = time.perf_counter() - t0
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(DP_WORLD)]
    got1 = dp_readings([r["stage1"] for r in ranks])
    got2 = dp_readings([r["stage2"] for r in ranks])
    loss1, worst1, name1, alphas1 = hold_stage1_step(ref1, got1, "[13] (b) stage 1")
    readings2 = stage2_readings()
    hold_stage2_step(ref2, got2, "[13] (b) stage 2", readings2, SEED)
    print(f"[13] (b) {DP_WORLD} gloo ranks at batch 1 on the card against one process at batch "
          f"2, ranks bitwise equal after the step; stage 1 (GIMM 64x64): loss within "
          f"{loss1:.2e} relative, largest gradient gap {worst1:.2e} x max|g_ref| ({name1}), "
          f"alphas {json.dumps(alphas1)}; stage 2 (GIMMVFI_R(raft_iters=2) 128x128): "
          f"{fmt_stage2(readings2)}; the spawned ranks took {seconds:.2f} s", flush=True)
    return {"stage1_loss_rel": loss1, "stage1_grad_rel": worst1, "stage2": readings2,
            "seconds": seconds}


def start_dp_cli(stage1_ckpt: str, lpips_path: Path, data: str) -> tuple[subprocess.Popen, Path]:
    """Phase 13 (c), started: phase 12 (c)'s first epoch as `torchrun
    --standalone --nproc_per_node 1 -m gimmvfi_tpu_torch.cli.train` on the
    same tree, checkpoint and LPIPS, in the background; its output in
    `cli.log`."""
    root = Path(__file__).resolve().parent
    log = WORK13 / "cli.log"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "gimmvfi_tpu_torch.cli.train", "--config", RECIPE2, "--result-path",
           str(WORK13 / "runs"), "--load-path", stage1_ckpt, "--lpips-path", str(lpips_path),
           "--smoke-test", "--overrides", "experiment.test_imlog_freq=1", f"dataset.path={data}",
           "experiment.epochs=1"]
    env = dict(os.environ, PYTHONPATH=str(root))
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return proc, log


def stop_group(proc: subprocess.Popen):
    """End torchrun and its ranks: SIGTERM to torchrun, which stops its
    workers, then SIGKILL to its process group for what is left."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def finish_dp_cli(proc: subprocess.Popen, log: Path, t0: float, p12_cli: dict) -> dict:
    """Phase 13 (c), ended: exit 0, one run directory, and its epoch-0
    metrics (`metrics.jsonl`) within 1e-4 relative of phase 12 (c)'s
    one-process run's."""
    try:
        code = proc.wait(timeout=600)
    finally:
        stop_group(proc)
    seconds = time.perf_counter() - t0
    text = log.read_text()
    if code != 0:
        raise AssertionError(f"[13] (c) torchrun exited {code}:\n{text[-4000:]}")
    (run_dir,) = (WORK13 / "runs").iterdir()
    (epoch0,) = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    ref, worst = p12_cli["epoch0"], 0.0
    for split in ("train", "valid", "valid_ema"):
        for k, want in ref[split].items():
            gap = abs(epoch0[split][k] - want) / max(abs(want), 1e-12)
            if not gap <= 1e-4:
                raise AssertionError(f"[13] (c) {split} {k}: {epoch0[split][k]} against phase 12 "
                                     f"(c)'s {want} ({gap:.2e} relative)")
            worst = max(worst, gap)
    mesh = [line for line in text.splitlines() if "mesh:" in line]
    print(f"[13] (c) torchrun --standalone --nproc_per_node 1 of the stage-2 CLI: exit 0 in "
          f"{seconds:.2f} s; {mesh[0].split('INFO ')[-1] if mesh else 'no mesh line'}; epoch 0 "
          f"within {worst:.2e} relative of phase 12 (c)'s metrics; train "
          f"{json.dumps(epoch0['train'])}", flush=True)
    return {"seconds": seconds, "metrics_rel": worst}


def run_phase13(smi: str, stage1_ckpt: str, p12: dict) -> dict:
    """Phase 13: data-parallel training on the one card."""
    shutil.rmtree(WORK13, ignore_errors=True)
    WORK13.mkdir(parents=True)
    lpips_path = WORK12 / "lpips_seeded.pt"
    seconds = {}
    t0 = time.perf_counter()
    res = {"step": run_dp_step(smi, lpips_path, p12["step"])}
    seconds["step"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc, log = start_dp_cli(stage1_ckpt, lpips_path, p12["cli"]["data"])
    try:
        res["ranks"] = run_dp_ranks()
    except BaseException:
        stop_group(proc)
        raise
    seconds["ranks"] = time.perf_counter() - t0
    res["cli"] = finish_dp_cli(proc, log, t0, p12["cli"])
    seconds["ranks_and_cli"] = time.perf_counter() - t0
    print(f"[13] phase 13 took {seconds['step'] + seconds['ranks_and_cli']:.2f} s "
          f"({', '.join(f'{k} {v:.2f}' for k, v in seconds.items())}; (c) ran beside (b))",
          flush=True)
    return res


# ------------------------------------------------------------------ phase 14
WORK14 = Path(__file__).resolve().parent / "build" / "chip_smoke_phase14"
SPATIAL_WORLD = 2  # gloo ranks on the one card
# (label, model keywords, (H, W), ds_factor, the least PSNR against one
# process or None, the most max-abs or None, launches a rank: sorted splat,
# windowed_corr_mma, windowed_corr_tf32, windowed_corr_bwd). (a)'s 34
# lookups: RAFT's 20 on the rank's query strip, windowed because the whole
# pair's volume is over the limit, and the AMT's 14 on the whole frame;
# (d)'s 14: the AMT's float32 windowed lookups over FlowFormer's feature map
SPATIAL_CASES = [
    ("a", {"raft_iters": 20, "dtype": torch.bfloat16}, (1088, 2048), 1.0, 50.0, None, (14, 34, 0, 0)),
    ("b", {"raft_iters": 20, "dtype": torch.bfloat16}, (2176, 4096), 0.25, 50.0, None, (14, 0, 0, 0)),
    ("c", {"raft_iters": 2}, (256, 512), None, None, 1e-5, (14, 0, 0, 0)),
    ("d", {"ff_iters": 32, "dtype": torch.bfloat16}, (736, 1280), None, 50.0, None, (14, 0, 14, 0)),
]


def spatial_family(kw: dict):
    """GIMMVFI_F for a case with FlowFormer's iterations, else GIMMVFI_R."""
    return GIMMVFI_F if "ff_iters" in kw else GIMMVFI_R
SPATIAL_KERNELS = (SPLAT_SORTED_KERNEL, WINDOWED_CORR_MMA_KERNEL, WINDOWED_CORR_TF32_KERNEL,
                   WINDOWED_CORR_BWD_KERNEL)


def raft_route(model, hw, ds) -> str:
    """RAFT's correlation route at this frame size, from the whole pair's
    volume as `RAFT.forward` and `forward_sharded` decide it; FlowFormer
    forms the cost rows of each rank's strip."""
    if isinstance(model, GIMMVFI_F):
        return "FlowFormer cost rows"
    h, w = (int(x * (ds or 1)) // 8 for x in hw)
    fmap = torch.empty(1, 256, h, w, dtype=model.dtype or torch.float32, device="meta")
    raft = model.flow_estimator
    return ("windowed" if 2 * corr_ops.volume_bytes(fmap, fmap) > raft.corr_max_volume_bytes
            else "materialized")


def spatial_references(device="cuda") -> tuple[list[dict], list[dict]]:
    """Phase 14's cases for the ranks and each case's one-process result on
    the card: `interpolate_sequential` on the same seeded weights and pair,
    with its launches counted from 0, its peak and seconds; where a case is
    held by max-abs, also the gap of a second one-process run to the first
    (the splat's atomic order alone)."""
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    cases, refs = [], []
    for label, kw, hw, ds, _, max_err, want in SPATIAL_CASES:
        family = spatial_family(kw)
        model = init_normal_(family(**kw, device=device), SEED)
        gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
        img = torch.rand((1, 2, *hw, 3), generator=gen)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = interpolate_sequential(model, img, ts, ds)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = tuple(k.launches for k in SPATIAL_KERNELS)
        if got != want:
            raise AssertionError(f"[14] ({label}) one process: launches {got}, expected {want}")
        refs.append({"imgt_pred": out["imgt_pred"].cpu(), "flowt": out["flowt"].cpu(),
                     "peak_bytes": torch.cuda.max_memory_allocated(), "seconds": seconds,
                     "route": raft_route(model, hw, ds)})
        with torch.inference_mode():
            t0 = time.perf_counter()
            model.prepare(img, ds)
            torch.cuda.synchronize()
            refs[-1]["prepare_seconds"] = time.perf_counter() - t0
        if max_err is not None:
            again = interpolate_sequential(model, img, ts, ds)["imgt_pred"].cpu()
            refs[-1]["rerun_max_abs_err"] = float((again - refs[-1]["imgt_pred"]).abs().max())
        cases.append({"family": family, "model_kw": {**kw, "device": device},
                      "state": {k: v.cpu() for k, v in model.state_dict().items()},
                      "img_xs": img, "t_values": ts, "ds_factor": ds})
        del model, out
        torch.cuda.empty_cache()
    return cases, refs


def run_phase14(smi: str, device="cuda:0") -> dict:
    """Phase 14: spatial sharding (`parallel/spatial.py`) on `SPATIAL_WORLD`
    gloo ranks on the one card (`spawn_ranks`; NCCL refuses two ranks on
    one device), RAFT's part of `prepare` sharded too (`prepare_sharded`),
    each case against one process on the same weights and pair: (a)
    2048x1088 DS 1.0 bf16, (b) 4096x2176 DS 0.25 bf16, both >= 50 dB, (c)
    GIMMVFI_R(raft_iters=2) float32 at 256x512, <= 1e-5 max-abs, one
    process against itself printed beside it, (d) GIMMVFI_F(ff_iters=32)
    bf16 at 720p, >= 50 dB, FlowFormer's query map sharded too; the ranks'
    results bitwise equal, exact launches a rank, the flow estimator's
    route, the peaks, and the seconds of a `prepare_sharded` alone on each
    rank beside one process's `prepare` (two ranks share the card: no
    speed figure)."""
    t_phase = time.perf_counter()
    shutil.rmtree(WORK14, ignore_errors=True)
    WORK14.mkdir(parents=True)
    cases, refs = spatial_references(device)
    torch.save(cases, WORK14 / "cases.pt")
    del cases
    gc.collect()
    t0 = time.perf_counter()
    dist_ops.spawn_ranks(spatial.interpolate_on_rank, SPATIAL_WORLD,
                         (str(WORK14 / "cases.pt"), str(WORK14)), device=device, backend="gloo",
                         rendezvous=str(WORK14 / "rendezvous"))
    spawn_seconds = time.perf_counter() - t0
    ranks = [torch.load(WORK14 / f"rank{r}.pt", weights_only=True) for r in range(SPATIAL_WORLD)]
    res = {}
    for i, (label, kw, (h, w), ds, min_db, max_err, want) in enumerate(SPATIAL_CASES):
        got, ref = ranks[0][i], refs[i]
        if not (bool(torch.isfinite(got["imgt_pred"]).all()) and bool(torch.isfinite(got["flowt"]).all())):
            raise AssertionError(f"[14] ({label}) non-finite outputs")
        for r, other in enumerate(ranks[1:], 1):
            if not all(torch.equal(other[i][k], got[k]) for k in ("imgt_pred", "flowt")):
                raise AssertionError(f"[14] ({label}) rank {r}'s result differs from rank 0's")
        launches = [tuple(rk[i]["launches"][k.name] for k in SPATIAL_KERNELS) for rk in ranks]
        if any(x != want for x in launches):
            raise AssertionError(f"[14] ({label}) launches a rank {launches}, expected {want}")
        if got["imgt_pred"].shape != ref["imgt_pred"].shape or got["flowt"].shape != ref["flowt"].shape:
            raise AssertionError(f"[14] ({label}) shapes {tuple(got['imgt_pred'].shape)}, "
                                 f"{tuple(got['flowt'].shape)}")
        db = psnr(got["imgt_pred"], ref["imgt_pred"])
        err = float((got["imgt_pred"] - ref["imgt_pred"]).abs().max())
        flow_err = float((got["flowt"] - ref["flowt"]).abs().max())
        if min_db is not None and not db >= min_db:
            raise AssertionError(f"[14] ({label}) {db:.2f} dB against one process < {min_db}")
        if max_err is not None and not max(err, flow_err) <= max_err:
            raise AssertionError(f"[14] ({label}) max-abs {err:.3e} (flowt {flow_err:.3e}) "
                                 f"against one process > {max_err}")
        peaks = [rk[i]["peak_bytes"] for rk in ranks]
        rerun = ref.get("rerun_max_abs_err")
        prep_s = [rk[i]["prepare_seconds"] for rk in ranks]
        res[label] = {"db": db, "max_abs_err": err, "flowt_max_abs_err": flow_err,
                      "one_process_rerun_max_abs_err": rerun, "raft_route": ref["route"],
                      "prepare_sharded_seconds": prep_s,
                      "one_process_prepare_seconds": ref["prepare_seconds"],
                      "launches": [dict(zip((k.name for k in SPATIAL_KERNELS), x)) for x in launches],
                      "peak_bytes": peaks, "one_process_peak_bytes": ref["peak_bytes"],
                      "seconds": [rk[i]["seconds"] for rk in ranks],
                      "one_process_seconds": ref["seconds"]}
        family = spatial_family(kw).__name__
        iters = kw.get("raft_iters", kw.get("ff_iters"))
        print(f"[14] ({label}) {family}({iters}) {w}x{h} DS {ds} "
              f"{'bf16' if kw.get('dtype') else 'float32'} 8x on {SPATIAL_WORLD} gloo ranks of "
              f"one card against "
              f"one process: imgt_pred {db:.2f} dB, max-abs {err:.3e}, flowt max-abs "
              f"{flow_err:.3e}"
              + ("" if rerun is None else f" (one process against itself: {rerun:.3e})")
              + f"; ranks bitwise equal; launches a rank (sorted splat, windowed_corr_mma, "
              f"windowed_corr_tf32, windowed_corr_bwd) {launches}, {ref['route']} on each "
              f"rank's strip; "
              f"prepare_sharded {', '.join(f'{1e3 * x:.2f}' for x in prep_s)} ms a rank against "
              f"one process's prepare {1e3 * ref['prepare_seconds']:.2f} ms; peak a rank "
              f"{', '.join(f'{p / 2**20:.1f}' for p in peaks)} MiB against one process's "
              f"{ref['peak_bytes'] / 2**20:.1f} MiB; the call {', '.join(f'{x:.2f}' for x in res[label]['seconds'])} "
              f"s a rank against {ref['seconds']:.2f} s (two ranks share the card: no speed "
              f"figure); {smi}", flush=True)
    res["spawn_seconds"] = spawn_seconds
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[14] phase 14 took {res['seconds']:.2f} s (the spawned ranks {spawn_seconds:.2f})",
          flush=True)
    return res


# ------------------------------------------------------------------ phase 15
FLOP_FIELDS = ("pipeline_tflops", "v100_speed_of_light_fps", "vs_baseline", "baseline_is_flop_bound")
TRAIN_STEPS15 = 20  # steps a stage of the training tool in (c)


def small_count(family, limit: int, device: str) -> tuple[dict, dict]:
    """`bench.count_flops` of one 8x call of `family`(2) float32 on a seeded
    small pair (R 128x192, F 128x128; 3 timesteps) at the correlation limit
    `limit`, seeded weights; with the launches of the call, counted from 0."""
    hw = (128, 192) if family is GIMMVFI_R else (128, 128)
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.random((1, 2, *hw, 3), dtype=np.float32)).to(device)
    model = init_normal_(family(2, device=device, corr_max_volume_bytes=limit), SEED)
    reset_counts()
    by_op = bench.count_flops(model, lambda: interpolate_sequential(model, img, [0.25, 0.5, 0.75]))
    return by_op, counts()


def check_counts_by_device() -> dict:
    """Phase 15 (a): the pipeline count on the card against the CPU's, for
    both families, materialized and windowed (`corr_max_volume_bytes=0`):
    equal, op by op (the windowed lookups charged `windowed_corr_work`'s
    dots on each device's own coordinates); the card's windowed lookups
    went through the 3xTF32 kernel (8 for R: RAFT's 2 and the AMT's 6; 6
    for F)."""
    res = {}
    for family in (GIMMVFI_R, GIMMVFI_F):
        for route, limit in (("materialized", corr_ops.MAX_VOLUME_BYTES), ("windowed", 0)):
            cpu, _ = small_count(family, limit, "cpu")
            gpu, got = small_count(family, limit, "cuda")
            lookups = (2 if family is GIMMVFI_R else 0) + 2 * 3 if limit == 0 else 0
            expect_counts(f"(a) {family.__name__} {route}", got, 6, tf32=lookups, phase=15)
            if gpu != cpu:
                raise AssertionError(f"[15] (a) {family.__name__} {route}: the card counts {gpu}, "
                                     f"the CPU {cpu}")
            res[f"{family.__name__}_{route}"] = sum(gpu.values())
            print(f"[15] (a) {family.__name__}(2) float32 {route}: {sum(gpu.values())} FLOPs on the "
                  f"card and on the CPU, op by op {json.dumps(gpu)}; card launches {got}", flush=True)
    return res


def count_paths(main_res: dict, ds: dict, f720: dict, benches: dict, smi: str) -> dict:
    """Phase 15 (b): the pipeline count of every path of phases 5, 8 and 9
    (a), each on a model built again from the same seed and the same seeded
    pair, launches counted from 0 and held to the timed run's; the achieved
    TFLOP/s from that phase's timed pair. 720p R's count must equal the
    bench's (phase 9 (b)): the same model, pair and materialized route."""
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    paths = [("720p", GIMMVFI_R, (H, W), None, SEED + 1, main_res),
             *((f"({label})", GIMMVFI_R, hw, dsf, SEED + 2, ds[label])
               for label, hw, dsf, _ in DS_PATHS),
             ("F 720p", GIMMVFI_F, (H, W), None, SEED + 1, f720)]
    res = {}
    for label, family, (h, w), dsf, seed, timed in paths:
        iters = 20 if family is GIMMVFI_R else 32
        model = init_normal_(family(iters, dtype=torch.bfloat16), SEED)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        img_xs = torch.rand((1, 2, h, w, 3), generator=gen).cuda()
        reset_counts()
        t0 = time.perf_counter()
        by_op = bench.count_flops(model, lambda: interpolate_sequential(model, img_xs, ts, dsf))
        seconds = time.perf_counter() - t0
        got = counts()
        want = {"splat": timed["splat_launches"], "mma": timed["windowed_launches"],
                "tf32": timed["tf32_launches"]}
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"[15] (b) {label}: counted call's launches {got}, the timed "
                                 f"run's {want}")
        flops = sum(by_op.values())
        tflops = flops / (timed["pair_ms"] / 1e3) / 1e12
        fields = bench.flop_fields(flops, timed["fps"], N_T)
        res[label] = {"flops": flops, "by_op": by_op, "achieved_tflops_per_s": tflops,
                      "fps": timed["fps"], "seconds": seconds, **fields}
        print(f"[15] (b) {family.__name__}({iters}) bf16 {w}x{h} DS {dsf or 1} 8x: {flops} FLOPs a "
              f"pair ({json.dumps(by_op)}); at phase {5 if label == '720p' else 9 if family is GIMMVFI_F else 8}'s "
              f"{timed['fps']:.4f} fps, {tflops:.2f} TFLOP/s achieved; the V100 speed of light "
              f"{fields['v100_speed_of_light_fps']} fps (vs_baseline {fields['vs_baseline']}); "
              f"counted in {seconds:.2f} s; {smi}", flush=True)
        del model, img_xs
        torch.cuda.empty_cache()
    if res["720p"]["flops"] != benches["r"]["pipeline_flops"]:
        raise AssertionError(f"[15] (b) 720p R counts {res['720p']['flops']}, the bench "
                             f"{benches['r']['pipeline_flops']}")
    return res


def run_train_tool(smi: str) -> dict:
    """Phase 15 (c): `tools.train_throughput.main` at `TRAIN_STEPS15` steps a
    stage, in this process: its record is its last line, each stage's
    losses finite; the launches counted from 0 over both stages (2 splats
    forward and 2 backward a stage-1 step, 6 and 6 a stage-2 step, no
    windowed one)."""
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        record = train_throughput.main(["--steps", str(TRAIN_STEPS15)])
    got = counts()
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"[15] (c) train_throughput --steps {TRAIN_STEPS15}: {line}", flush=True)
    if json.loads(lines[-1]) != record:
        raise AssertionError("[15] (c) the training tool's last line is not its record")
    for stage in ("stage1", "stage2"):
        curve = record[stage]["loss_curve"]
        if len(curve) != 5 or not all(math.isfinite(loss) for _, loss in curve):
            raise AssertionError(f"[15] (c) {stage} loss curve {curve}")
    expect_counts("(c) the training tool", got, 8 * TRAIN_STEPS15, splat_bwd=8 * TRAIN_STEPS15,
                  phase=15)
    return {**record, "launches": got}


def run_phase15(main_res: dict, ds: dict, f720: dict, benches: dict, smi: str) -> dict:
    t0 = time.perf_counter()
    res = {"by_device": check_counts_by_device()}
    torch.cuda.empty_cache()
    res["paths"] = count_paths(main_res, ds, f720, benches, smi)
    res["train"] = run_train_tool(smi)
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"[15] phase 15 took {res['seconds']:.2f} s", flush=True)
    return res


# ------------------------------------------------------------------ phase 16
WORK16 = Path(__file__).resolve().parent / "build" / "chip_smoke_phase16"
REMAT_TIMED = 2  # steps timed a mode in (a), after the counted one
# (b): a (batch, side) crop at which the AMT's bidirectional float32 volume
# (2 N (side/8)^4 x 4 B x 4/3) passes `corr_ops.MAX_VOLUME_BYTES` while
# RAFT's one-direction volume (half of it) stays materialized: of 4 x 704^2,
# 2 x 832^2 and 1 x 960^2, tried in that order, the first whose remat step
# fits one card
TRIGGER = (1, 960)
TRIGGER_WHY = ("batch 4 at 704^2 and batch 2 at 832^2 run out of the 80 GB card's memory with "
               "remat, batch 1 at 960^2 fits")
TRIGGER_TIMED = 2  # steps timed in (b), after the counted one


class BwdEvents:
    """Stands in for the windowed backward kernel in `ops.corr` and times
    each call by CUDA events, the host first waiting for the card, so that
    the events hold the call's own work (its kernels, its sort and plan)
    and none queued before it. A profiler trace of a whole step at (b)'s
    crop takes minutes to read."""

    def __init__(self, kernel=WINDOWED_CORR_BWD_KERNEL):
        self.kernel, self.events = kernel, []

    def __call__(self, wc, coords, g, radius=4, need_coords=True):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.kernel(wc, coords, g, radius, need_coords)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.events]


def remat_turn(make_state, step, batch, splats: int, timed: int, label: str) -> dict:
    """One mode of phase 16 (a): a fresh seeded state (`make_state()`), its
    first step counted from 0 (exactly `splats` forward and backward splat
    launches, no windowed one) and its peak allocated, then `timed` steps
    by CUDA events. Returns the first step's loss, gradients and running
    statistics (kept on the card), the peak and the times."""
    gc.collect()
    torch.cuda.empty_cache()
    state = make_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    got = counts()
    expect_counts(f"(a) {label}", got, splats, splat_bwd=splats, phase=16)
    model = state.model
    res = {"loss": float(metrics["loss_total"]), "peak_bytes": peak, "launches": got,
           "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
           "stats": {k: v.detach().clone() for k, v in model.state_dict().items()
                     if "running_" in k}}
    res["times"] = [bench.timed(lambda: step(state, batch), torch.device("cuda"))[1]
                    for _ in range(timed)]
    res["step_ms"] = statistics.median(res["times"]) if timed else None
    del state, model, metrics
    gc.collect()  # the optimizer and its schedule's hook hold each other
    torch.cuda.empty_cache()
    return res


def hold_remat(plain: dict, again: dict, remat: dict, where: str) -> dict:
    """Phase 16 (a)'s bounds on one recipe: the loss and the running
    statistics bitwise between the modes (and the plain step's loss
    bitwise again); each gradient within 1e-5 x max(1, max|g|) of the
    plain one. The step's backward is not deterministic on the card
    (`grid_sample`'s backward adds with atomics), so two plain steps agree
    bitwise on a tensor only by chance: the readings count the tensors
    bitwise under remat, those bitwise between the two plain steps, and
    give the largest gap of each beside the other. Raises on a miss."""
    if remat["loss"] != plain["loss"] or again["loss"] != plain["loss"]:
        raise AssertionError(f"{where}: losses {plain['loss']!r} (plain), {again['loss']!r} "
                             f"(plain again), {remat['loss']!r} (remat)")
    for k, v in plain["stats"].items():
        if not torch.equal(remat["stats"][k], v):
            raise AssertionError(f"{where}: running statistic {k} differs under remat")
    res = {"loss": plain["loss"], "tensors": len(plain["grads"]), "stats": len(plain["stats"])}
    for label, other in (("remat", remat), ("plain_again", again)):
        bitwise, worst = 0, (0.0, None)
        for name, g in plain["grads"].items():
            if torch.equal(other["grads"][name], g):
                bitwise += 1
                continue
            gap = float((other["grads"][name] - g).abs().max()) / max(1.0, float(g.abs().max()))
            if not gap <= 1e-5:
                raise AssertionError(f"{where}: the gradient of {name} is {gap:.3e} x max(1, "
                                     f"max|g|) off ({label} against plain)")
            worst = max(worst, (gap, name))
        res.update({f"{label}_bitwise": bitwise, f"{label}_worst_gap": worst[0],
                    f"{label}_worst_gap_name": worst[1]})
    return res


def run_remat_recipes(smi: str, lpips_path: Path) -> dict:
    """Phase 16 (a): each recipe's step (stage 1: GIMM, batch 32 at 256^2;
    stage 2: GIMMVFI_R(raft_iters=20) and GIMMVFI_F(), batch 4 at 224^2, the
    perceptual loss), float32 with TF32 off, from one seed, with remat off,
    on and off again (`remat_turn`, `hold_remat`): ms a step and the peak
    in both modes, the loss, statistics and gradients held."""
    cfg1, cfg2, cfg2f = (load_config(c) for c in (RECIPE, RECIPE2, RECIPE2_F))
    n1 = cfg1.experiment.batch_size
    gimm_batch = flow_batch(n1, (CROP, CROP), SEED + 41)
    gimm_batch["t_id"] = np.full((n1,), 1, np.int32)
    vfi = vfi_batch(cfg2.experiment.batch_size, (CROP2, CROP2), SEED + 42)
    lpips_fn = train_cli.lpips_loss_fn(str(lpips_path), torch.device("cuda"))
    recipes = {
        "stage1": (lambda remat: recipe_state(cfg1, remat=remat),
                   make_gimm_train_step(use_ema=bool(cfg1.arch.ema)), gimm_batch, 2),
        "stage2_r": (lambda remat: vfi_state(cfg2, raft_iters=cfg2.arch.raft_iter, remat=remat),
                     make_gimmvfi_train_step(cfg2.arch.rec_weight, lpips_fn,
                                             use_ema=bool(cfg2.arch.ema)), vfi, STEP_SPLATS),
        "stage2_f": (lambda remat: vfi_state(cfg2f, GIMMVFI_F, remat=remat),
                     make_gimmvfi_train_step(cfg2f.arch.rec_weight, lpips_fn,
                                             use_ema=bool(cfg2f.arch.ema)), vfi, STEP_SPLATS),
    }
    res = {}
    for name, (make_state, step, batch, splats) in recipes.items():
        turns = {}
        for label, remat, timed in (("plain", False, REMAT_TIMED), ("remat", True, REMAT_TIMED),
                                    ("plain_again", False, 0)):
            turns[label] = remat_turn(lambda: make_state(remat), step, batch, splats, timed,
                                      f"{name} {label}")
        held = hold_remat(turns["plain"], turns["plain_again"], turns["remat"], f"[16] (a) {name}")
        res[name] = {**held, **{f"{label}_{k}": turns[label][k]
                                for label in ("plain", "remat") for k in ("step_ms", "times",
                                                                          "peak_bytes")}}
        r = res[name]
        print(f"[16] (a) {name}: remat off {r['plain_step_ms']:.2f} ms a step (median of "
              f"{REMAT_TIMED} by events), peak {r['plain_peak_bytes'] / 2**20:.1f} MiB; remat on "
              f"{r['remat_step_ms']:.2f} ms, peak {r['remat_peak_bytes'] / 2**20:.1f} MiB "
              f"({100 * r['remat_peak_bytes'] / r['plain_peak_bytes']:.1f}% of off); loss "
              f"{r['loss']!r} bitwise in both modes, {r['stats']} running statistics bitwise; "
              f"gradients on against off bitwise in {r['remat_bitwise']} of {r['tensors']} "
              f"tensors, the largest gap {r['remat_worst_gap']:.3e} x max(1, max|g|) "
              f"({r['remat_worst_gap_name']}); off against off again bitwise in "
              f"{r['plain_again_bitwise']}, the largest gap {r['plain_again_worst_gap']:.3e} "
              f"({r['plain_again_worst_gap_name']}); launches a step "
              f"{turns['remat']['launches']} in both; {smi}", flush=True)
        del turns
        if not r["remat_peak_bytes"] < r["plain_peak_bytes"]:
            raise AssertionError(f"[16] (a) {name}: remat's peak {r['remat_peak_bytes']} is not "
                                 f"below {r['plain_peak_bytes']}")
    return res


def run_trigger_step(smi: str, lpips_path: Path, plain_peak_224: int, shape=TRIGGER) -> dict:
    """Phase 16 (b): one recipe step of GIMMVFI_R(raft_iters=20) with remat
    on (its default), float32, the perceptual loss, at `shape` (batch,
    side): there the AMT's bidirectional volume passes the 2 GiB limit and
    its lookups go to the windowed kernels, RAFT's stays materialized
    (asserted from the shapes and by exact launches: the AMT's 2 float32
    windowed lookups and their 2 backwards on the fast cases, 6 + 6
    splats, no other). One step counted from 0, `TRIGGER_TIMED` timed by
    CUDA events, the last of them with each windowed backward call timed
    by events too (`BwdEvents`: the host waits for the card before each);
    the peak, finite losses; the step without remat reckoned from (a)'s
    peak at 224^2, by pixels."""
    cfg = load_config(RECIPE2)
    n, side = shape
    amt_bytes = 2 * n * (side // 8) ** 4 * 4 * 4 // 3
    if not amt_bytes > corr_ops.MAX_VOLUME_BYTES >= amt_bytes // 2:
        raise AssertionError(f"[16] (b) {n} x {side}^2 is no windowed trigger: the AMT's volume "
                             f"{amt_bytes} B, the limit {corr_ops.MAX_VOLUME_BYTES}")
    gc.collect()
    torch.cuda.empty_cache()
    state = vfi_state(cfg, raft_iters=cfg.arch.raft_iter)
    if not state.model.remat:
        raise AssertionError("[16] (b) the recipe's model is built without remat")
    lpips_fn = train_cli.lpips_loss_fn(str(lpips_path), torch.device("cuda"))
    step = make_gimmvfi_train_step(cfg.arch.rec_weight, lpips_fn, use_ema=bool(cfg.arch.ema))
    batch = vfi_batch(n, (side, side), SEED + 43)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, first_ms = bench.timed(lambda: step(state, batch), torch.device("cuda"))
    got = counts()
    expect_counts("(b) the trigger-shape step", got, STEP_SPLATS, tf32=2, splat_bwd=STEP_SPLATS,
                  phase=16, corr_bwd=2)
    losses = [float(metrics["loss_total"])]
    times, recorder = [], BwdEvents()
    for i in range(TRIGGER_TIMED):
        if i == TRIGGER_TIMED - 1:
            corr_ops.WINDOWED_CORR_BWD_KERNEL = recorder
        try:
            metrics, ms = bench.timed(lambda: step(state, batch), torch.device("cuda"))
        finally:
            corr_ops.WINDOWED_CORR_BWD_KERNEL = WINDOWED_CORR_BWD_KERNEL
        times.append(ms)
        losses.append(float(metrics["loss_total"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[16] (b) losses {losses}")
    bwd_ms = recorder.ms()
    if len(bwd_ms) != 2:
        raise AssertionError(f"[16] (b) {len(bwd_ms)} windowed backward calls timed, expected 2")
    med = statistics.median(times)
    reckoned = plain_peak_224 * n * side ** 2 / (4 * CROP2 ** 2)
    print(f"[16] (b) one recipe step of GIMMVFI_R(raft_iters={cfg.arch.raft_iter}) with remat, "
          f"float32, the perceptual loss, batch {n} at {side}x{side} ({TRIGGER_WHY}): the AMT's "
          f"volume {amt_bytes / 1e9:.3f} GB > the {corr_ops.MAX_VOLUME_BYTES / 2**30:.0f} GiB "
          f"limit, RAFT's {amt_bytes // 2 / 1e9:.3f} GB materialized; launches {got}; "
          f"{med:.2f} ms a step (median of {TRIGGER_TIMED} by events; "
          f"{', '.join(f'{t:.2f}' for t in times)}; the counted first {first_ms:.2f}); peak "
          f"allocated {peak / 2**20:.1f} MiB (without remat reckoned {reckoned / 2**20:.0f} MiB "
          f"from (a)'s 224^2 peak by pixels); losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; the 2 windowed backward calls "
          f"{', '.join(f'{x:.4f}' for x in bwd_ms)} ms by events in the last step; {smi}",
          flush=True)
    del state, batch, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": n, "side": side, "amt_volume_bytes": amt_bytes, "launches": got,
            "step_ms": med, "step_ms_all": times, "first_ms": first_ms, "peak_bytes": peak,
            "plain_peak_reckoned_bytes": reckoned, "losses": losses, "bwd_ms": bwd_ms}


def run_phase16(smi: str) -> dict:
    """Phase 16: remat (activation recomputation) in both training
    recipes, float32, TF32 off, in build/chip_smoke_phase16/."""
    t0 = time.perf_counter()
    shutil.rmtree(WORK16, ignore_errors=True)
    WORK16.mkdir(parents=True)
    lpips_path = WORK16 / "lpips_seeded.pt"
    torch.manual_seed(SEED)
    torch.save(LPIPS(device="cpu").state_dict(), lpips_path)
    res = {"recipes": run_remat_recipes(smi, lpips_path)}
    res["trigger"] = run_trigger_step(smi, lpips_path,
                                      res["recipes"]["stage2_r"]["plain_peak_bytes"])
    res["seconds"] = time.perf_counter() - t0
    print(f"[16] phase 16 took {res['seconds']:.2f} s", flush=True)
    return res


def general_numbers(readings, key):
    """A general case's numbers: at radius 8 (4 levels) as its own, at
    6 levels (radius 4) and the fast case at radius 4 (4 levels) of the
    same run beside them, where read."""
    main = readings[f"{key}_r8_l4"]
    out = {k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_device_ms")}
    out["radius"], out["levels"] = 8, 4
    for label, reading in (("levels6", readings.get(f"{key}_r4_l6")),
                           ("fast_r4", readings.get(f"{key}_r4_l4"))):
        if reading is not None:
            out.update({f"{label}_{k}": reading[k] for k in ("ms", "device_ms", "bound_ms",
                                                             "bound_by", "library_ms")})
    return out


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = check_card()
    build_kernels()
    kstats = check_kernel()
    sstats = check_sorted_kernel()
    check_small_e2e()
    options_db = {label: check_small_e2e(4, (128, 192), None, limit, **R_OPTIONS)
                  for label, limit in (("materialized", corr_ops.MAX_VOLUME_BYTES),
                                       ("windowed", 0))}
    # the general case on small paths: the AMT at radius 6 in both dtypes,
    # RAFT at 5 levels and radius 5
    wide_small = {}
    for dtype, general in ((torch.float32, WINDOWED_CORR_TF32_GENERAL_KERNEL),
                           (torch.bfloat16, WINDOWED_CORR_MMA_GENERAL_KERNEL)):
        db, fast = check_small_e2e(4, (128, 192), None, 0, dtype=dtype, corr_radius=6)
        wide_small[str(dtype)[6:]] = {"db": db, "fast_launches": fast,
                                      "general_launches": general.launches}
    raft_l5 = check_raft_gpu_vs_cpu()
    splat_launches, main_splat, main_res = run_main_path()
    torch.cuda.empty_cache()
    conv_err = check_conv()
    gather_err = check_gathers()
    conv, gathers, launches = run_probes()
    floor = launch_floor_ms()
    print(f"[6] launch floor: an empty kernel of one warp, device {fmt_ms(floor, 6)}", flush=True)
    for name, g in gathers.items():
        g["floor_ms"] = floor
        g["floor_bound_ms"] = None if floor is None else max(floor, g["bound_ms"])
        dev = g["device_ms"]
        share = ("not measured" if g["floor_bound_ms"] is None
                 else fmt_share(g["floor_bound_ms"], dev))
        print(f"[6] {name}: device {fmt_ms(dev, 6)}; against max(launch floor, bound) "
              f"{fmt_ms(g['floor_bound_ms'], 6)}: {share}", flush=True)
    print(f"[6] conv3x3 (1,{H},{W},256): kernel {conv['kernel_ms']:.4f} ms "
          f"({100 * conv['bound_ms'] / conv['kernel_ms']:.1f}% of its {conv['bound_ms']:.4f} ms "
          f"bound; device time {fmt_ms(conv['kernel_device_ms'])}), cuDNN NCHW "
          f"{conv['cudnn_nchw_ms']:.4f} ms, cuDNN channels-last {conv['cudnn_channels_last_ms']:.4f} "
          f"ms (device time {fmt_ms(conv['cudnn_channels_last_device_ms'])}), plain "
          f"{conv['plain_ms']:.4f} ms; {smi}",
          flush=True)
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    wstats = check_windowed()
    wstats["readings"] = window_readings(smi)
    bstats = check_windowed_backward(smi)
    print(f"[7] phase 7 took {time.perf_counter() - t7:.2f} s", flush=True)
    ds = run_ds_paths()
    wide = run_wide_radius_path(smi)
    f720 = run_f_path(smi)
    benches = run_bench_entries()
    f_db = {label: check_small_e2e(9, (128, 192), None, limit, family=GIMMVFI_F)
            for label, limit in (("materialized", corr_ops.MAX_VOLUME_BYTES), ("windowed", 0))}
    torch.cuda.empty_cache()
    p10 = run_phase10(smi)
    torch.cuda.empty_cache()
    p11 = run_phase11(smi)
    torch.cuda.empty_cache()
    stage1_ckpt = str(Path(p11["cli"]["run_dir"]) / "ckpt" / "step_4.pt")
    p12 = run_phase12(smi, stage1_ckpt)
    torch.cuda.empty_cache()
    p13 = run_phase13(smi, stage1_ckpt, p12)
    torch.cuda.empty_cache()
    p14 = run_phase14(smi)
    torch.cuda.empty_cache()
    p15 = run_phase15(main_res, ds, f720, benches, smi)
    torch.cuda.empty_cache()
    p16 = run_phase16(smi)
    t16 = p16["trigger"]
    p14_launches = {key: {label: [x[key] for x in p14[label]["launches"]]
                          for label, *_ in SPATIAL_CASES}
                    for key in (SPLAT_SORTED_KERNEL.name, WINDOWED_CORR_MMA_KERNEL.name,
                                WINDOWED_CORR_TF32_KERNEL.name)}
    # each kernel's launches on the phase 10 paths, each counted from 0
    p10_paths = {"gimm_forward": p10["gimm"]["forward"], "gimm_forward_multi": p10["gimm"][
        "forward_multi"], "video_cli": p10["video"], **p10["harnesses"]}
    p10_launches = {key: {k: v["launches"][key] for k, v in p10_paths.items()}
                    for key in ("splat", "tf32")}

    def record(kernel, launches, **numbers):
        return {"name": kernel.name, "route": "cuda", "source": kernel.source,
                "replaces": kernel.replaces, "launches": launches, **numbers}

    def windowed_numbers(key):
        """One windowed kernel's times from phase 7 (and the path's lookups)."""
        main, lk = wstats["in_frame"], ds["lookups"]
        out = {"ms": main[f"{key}_ms"], "device_ms": main[f"{key}_device_ms"],
               "plain_ms": wstats["plain_ms"], "bound_ms": main["bound_ms"],
               "bound_by": main["bound_by"], "library_ms": main["library_ms"],
               "library_device_ms": main["library_device_ms"]}
        for label, reading in (("smooth", wstats["smooth"]), ("p720", wstats["p720"]),
                               ("path_first", lk["first"]), ("path_last", lk["last"])):
            out.update({f"{label}_{k}": reading[f"{key}_{k}"] for k in ("ms", "device_ms")})
            out[f"{label}_bound_ms"] = reading["bound_ms"]
        out["p720_materialized_ms"] = wstats["p720"]["materialized_ms"]
        out["p720_materialized_device_ms"] = wstats["p720"]["materialized_device_ms"]
        return out

    lk = f720["lookup"]
    wa = p12["windowed_step"]["a"]
    records = [
        # the route of every path: the deterministic splat
        record(SPLAT_SORTED_KERNEL, splat_launches, **sstats, **main_splat,
               launches_phase10=p10_launches["splat"],
               launches_phase11_step=p11["step"]["launches"]["splat"],
               launches_phase12_step=p12["step"]["launches"]["splat"],
               launches_phase13_step=p13["step"]["launches"]["splat"],
               launches_phase14=p14_launches[SPLAT_SORTED_KERNEL.name],
               launches_phase16_trigger_step=t16["launches"]["splat"],
               phase11_step_device_ms=p11["step"]["splat_fwd_device_ms"],
               phase12_step_device_ms=p12["step"]["splat_fwd_device_ms"]),
        # the atomic splat, on no route (0 launches on every path, asserted):
        # its times in phase 3 and at stage-1 training's shape (phase 11 (a))
        record(SPLAT_KERNEL, 0, **kstats,
               train_shape_ms=p11["backward"]["forward_ms"],
               train_shape_device_ms=p11["backward"]["forward_device_ms"],
               train_shape_bound_ms=p11["backward"]["forward_bound_ms"],
               train_shape_library_ms=p11["backward"]["forward_library_ms"],
               train_shape_library_device_ms=p11["backward"]["forward_library_device_ms"]),
        # the training path's kernel: its launches in one recipe step
        # (phase 11 (b), counted from 0), its times at that step's shape
        record(SPLAT_BACKWARD_KERNEL, p11["step"]["launches"]["splat_bwd"],
               **{k: v for k, v in p11["backward"].items() if not k.startswith("forward_")},
               step_device_ms=p11["step"]["splat_bwd_device_ms"],
               launches_phase11_cli=p11["cli"]["launches"]["splat_bwd"],
               launches_phase12_step=p12["step"]["launches"]["splat_bwd"],
               launches_phase13_step=p13["step"]["launches"]["splat_bwd"],
               launches_phase16_trigger_step=t16["launches"]["splat_bwd"],
               phase12_step_device_ms=p12["step"]["splat_bwd_device_ms"]),
        record(WINDOWED_CORR_MMA_KERNEL, ds["c"]["windowed_launches"],
               max_abs_err=max(wstats["path_err"], ds["lookups"]["first"]["max_abs_err"],
                               ds["lookups"]["last"]["max_abs_err"]),
               max_abs_err_cases_bf16=wstats["max_abs_err_cases_bf16"],
               max_abs_err_radius3=wstats["max_abs_err_radius3_bf16"],
               library_max_abs_err=wstats["in_frame"]["library_max_abs_err"],
               tolerance=wstats["tolerance"], **windowed_numbers("mma"),
               extent_in_frame=fmt_extent(wstats["in_frame"]),
               extent_smooth=fmt_extent(wstats["smooth"]),
               extent_path_first=fmt_extent(ds["lookups"]["first"]),
               launches_phase14=p14_launches[WINDOWED_CORR_MMA_KERNEL.name]),
        # the float32 route, on the 720p F path: its launches there and its
        # times on that path's captured AMT lookup, beside the materialized
        # float32 lookup's and the library composition's (the volume formed
        # from the same maps, pooled and sampled)
        record(WINDOWED_CORR_TF32_KERNEL, f720["tf32_launches"],
               launches_f32_gpu_vs_cpu={"r": ds["f32_windowed_launches"],
                                        "f": f_db["windowed"][1]},
               max_abs_err=max(f720["lookup_max_abs_err"],
                               *p10["video"]["lookup_max_abs_err"].values()),
               max_abs_err_phase10=p10["video"]["lookup_max_abs_err"],
               max_abs_err_cases_f32=wstats["max_abs_err_cases_f32"],
               max_abs_err_radius3=wstats["max_abs_err_radius3_f32"],
               launches_options_gpu_vs_cpu=options_db["windowed"][1],
               launches_phase14=p14_launches[WINDOWED_CORR_TF32_KERNEL.name],
               tolerance=wstats["tolerance"], ms=lk["tf32_ms"], device_ms=lk["tf32_device_ms"],
               plain_ms=lk["plain_ms"], bound_ms=lk["tf32_bound_ms"], bound_by=lk["tf32_bound_by"],
               bytes_bound_ms=lk["bytes_bound_ms"], library_ms=lk["library_ms"],
               library_device_ms=lk["library_device_ms"],
               materialized_ms=lk["materialized_ms"],
               materialized_device_ms=lk["materialized_device_ms"], extent=lk["extent"],
               decode_one_ms=f720["decode_turns"]["tf32"],
               launches_phase10=p10_launches["tf32"],
               launches_phase12_windowed_step=p12["windowed_step"]["launches"]["tf32"],
               launches_phase16_trigger_step=t16["launches"]["tf32"]),
        # the windowed lookup's backward: its launches in the windowed recipe
        # step (phase 12 (e), counted from 0; 0 on every inference path,
        # asserted), its times there on the captured AMT lookup (a), beside
        # the yardstick (the materialized lookup's autograd backward), and at
        # (b) the 720p F AMT lookup and (c) the 2K DS 1.0 RAFT lookup in bf16
        record(WINDOWED_CORR_BWD_KERNEL, p12["windowed_step"]["launches"]["corr_bwd"],
               max_abs_err=max(bstats["max_abs_err_cases_f32"], wa["max_abs_err"]),
               max_abs_err_cases_bf16=bstats["max_abs_err_cases_bf16"],
               coords_max_abs_err=max(bstats["coords_max_abs_err_cases_f32"],
                                      bstats["coords_max_abs_err_cases_bf16"], wa["coords_max_abs_err"]),
               route_max_abs_err_f32=bstats["route_max_abs_err_f32"],
               route_max_abs_err_bf16=bstats["route_max_abs_err_bf16"],
               tolerance=bstats["tolerance"], ms=wa["ms"], device_ms=wa["device_ms"],
               plain_ms=wa["plain_ms"],
               bound_ms=wa["bound_ms"], bound_by=wa["bound_by"], library_ms=wa["library_ms"],
               library_device_ms=wa["library_device_ms"], forward_ms=wa["forward_ms"],
               forward_device_ms=wa["forward_device_ms"],
               d_levels_bitwise_repeat=True, parts_device_ms=wa["parts_device_ms"],
               step_bwd_device_ms=p12["windowed_step"]["bwd_device_ms"],
               launches_phase16_trigger_step=t16["launches"]["corr_bwd"],
               phase16_trigger_step_bwd_ms=t16["bwd_ms"],
               **{f"{key}_{k}": bstats[key][k] for key in ("b", "c")
                  for k in ("ms", "device_ms", "parts_device_ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "library_device_ms", "forward_ms", "forward_device_ms")},
               **{f"{key}_{k}": reading[k] for key, reading in (("a", wa), ("b", bstats["b"]),
                                                                ("c", bstats["c"]))
                  for k in ("no_coords_ms", "no_coords_device_ms", "no_coords_bound_ms")}),
        # the "before" kernel, on no path: its times on the same captured
        # lookup in the same run; the bf16_* times are the bf16 tensor-core
        # kernel's "before" at the 2K DS 1.0 lookups
        record(WINDOWED_CORR_KERNEL, f720["cuda_core_launches"],
               max_abs_err=lk["cuda_core_max_abs_err"],
               max_abs_err_cases_f32=wstats["cuda_core_max_abs_err_cases_f32"],
               max_abs_err_bf16_timed=max(wstats[k]["cuda_core_max_abs_err"]
                                          for k in PATH_KINDS + ("p720",)),
               tolerance=wstats["tolerance"], times_dtype="float32", ms=lk["cuda_core_ms"],
               device_ms=lk["cuda_core_device_ms"], plain_ms=lk["plain_ms"],
               bound_ms=lk["cuda_core_bound_ms"], bound_by=lk["cuda_core_bound_by"],
               library_ms=lk["library_ms"], library_device_ms=lk["library_device_ms"],
               decode_one_ms=f720["decode_turns"]["cuda_core"],
               **{f"bf16_{k}": v for k, v in windowed_numbers("cuda_core").items()
                  if not k.startswith("library")}),
        record(CONV3X3_KERNEL, launches[CONV3X3_KERNEL.name], max_abs_err=conv_err,
               ms=conv["kernel_ms"], device_ms=conv["kernel_device_ms"],
               plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"], bound_by=conv["bound_by"],
               library_ms=conv["cudnn_channels_last_ms"],
               library_device_ms=conv["cudnn_channels_last_device_ms"]),
    ] + [
        record(GATHERS[name][0], launches[name], max_abs_err=gather_err[name], **gathers[name])
        for name in GATHERS
    ] + [
        # the general cases: their launches on their own paths, their times
        # at radius 8 beside the fast case's and at 6 levels in the same run
        record(WINDOWED_CORR_MMA_GENERAL_KERNEL,
               wide["general_launches"][WINDOWED_CORR_MMA_GENERAL_KERNEL.name],
               max_abs_err=max(wstats["general"]["max_abs_err_bf16"],
                               *(r["max_abs_err"] for k, r in wstats["readings"].items()
                                 if k.startswith("mma"))),
               launches_phase4_bf16=wide_small["bfloat16"]["general_launches"],
               phase8_d={k: wide[k] for k in ("fps", "pair_ms", "prepare_ms", "decode_ms",
                                              "peak_bytes", "windowed_launches")},
               **general_numbers(wstats["readings"], "mma")),
        record(WINDOWED_CORR_TF32_GENERAL_KERNEL, wide_small["float32"]["general_launches"],
               max_abs_err=max(wstats["general"]["max_abs_err_f32"],
                               *(r["max_abs_err"] for k, r in wstats["readings"].items()
                                 if k.startswith("tf32"))),
               launches_raft_levels5=raft_l5["launches"],
               launches_phase12_wide_step=p12["wide_radius_step"]["launches"]["tf32_general"],
               **general_numbers(wstats["readings"], "tf32")),
        record(WINDOWED_CORR_BWD_GENERAL_KERNEL,
               p12["wide_radius_step"]["launches"]["corr_bwd_general"],
               max_abs_err=max(bstats["general"]["max_abs_err_f32"],
                               bstats["general"]["max_abs_err_bf16"],
                               *(r["max_abs_err"] for r in bstats["readings"].values()
                                 if r["max_abs_err"] is not None)),
               coords_max_abs_err=bstats["general"]["coords_max_abs_err"],
               **general_numbers(bstats["readings"], "b"),
               **{f"{key}_{k}": bstats["readings"][key][k]
                  for key in ("a_r4_l4", "a_r8_l4", "c_r8_l4", "c_r4_l6")
                  for k in ("ms", "device_ms", "bound_ms", "bound_by", "plain_ms", "library_ms")}),
    ]
    print(f"[4] GIMMVFI_R(2, {', '.join(f'{k}={v}' for k, v in R_OPTIONS.items())}) GPU vs CPU: "
          f"{options_db['materialized'][0]:.2f} dB materialized, {options_db['windowed'][0]:.2f} "
          f"dB windowed ({options_db['windowed'][1]} windowed_corr_tf32 launches at radius 3); "
          f"GIMMVFI_R(2, corr_radius=6, corr_max_volume_bytes=0) "
          + ", ".join(f"{k} {v['db']:.2f} dB ({v['fast_launches']} fast, {v['general_launches']} "
                      f"general launches)" for k, v in wide_small.items())
          + f"; RAFT at 5 levels, radius 5: flows {raft_l5['max_abs_err'] / raft_l5['scale']:.2e} "
          f"relative", flush=True)
    print(f"[9] F path: {f720['fps']:.4f} fps at 720p; bench lines "
          f"{json.dumps(benches)}; GPU vs CPU F {f_db['materialized'][0]:.2f} dB materialized, "
          f"{f_db['windowed'][0]:.2f} dB windowed", flush=True)
    video, gimm = p10["video"], p10["gimm"]
    print(f"[10] GIMM {gimm['forward']['ms']:.3f} ms a forward, {gimm['ms_per_t']:.3f} ms a "
          f"forward_multi timestep; video CLI 720p float32 8x: "
          f"{', '.join(f'{ms:.2f}' for ms in video['pair_ms'])} ms a pair, peak "
          f"{video['peak_bytes'] / 2**20:.1f} MiB; harnesses "
          f"{json.dumps({k: v['result'] for k, v in p10['harnesses'].items()})}; {smi}",
          flush=True)
    step, cli = p11["step"], p11["cli"]
    print(f"[11] stage-1 training: {step['step_ms']:.2f} ms a recipe step (batch 32, 256x256), "
          f"peak {step['peak_bytes'] / 2**20:.1f} MiB; the splat backward "
          f"{fmt_ms(p11['backward']['device_ms'])} device against its "
          f"{p11['backward']['bound_ms']:.4f} ms bound; GPU vs CPU loss "
          f"{p11['gpu_vs_cpu']['loss_rel']:.2e}, gradients {p11['gpu_vs_cpu']['grad_rel']:.2e}; "
          f"the CLI {cli['steps']} steps, {', '.join(f'{x:.2f}' for x in cli['epoch_seconds'])} s "
          f"an epoch, PyYAML {yaml.__version__}, "
          f"tensorboardX {'found' if cli['writer'] == 'tensorboardX' else 'not found'}; {smi}",
          flush=True)
    s2, c2, f2, w2 = p12["step"], p12["cli"], p12["f_step"], p12["windowed_step"]
    print(f"[12] stage-2 training: {s2['step_ms']:.2f} ms a recipe step (GIMMVFI_R, batch 4, "
          f"224x224, the perceptual loss), peak {s2['peak_bytes'] / 2**20:.1f} MiB, splats "
          f"{fmt_ms(None if s2['splat_fwd_device_ms'] is None else s2['splat_fwd_device_ms'] + s2['splat_bwd_device_ms'])}"
          f" device a step; GPU vs CPU loss {p12['gpu_vs_cpu']['loss_rel']:.2e}, gradients "
          f"{p12['gpu_vs_cpu']['grad_rel_l2']:.2e} relative L2; the CLI {c2['steps']} steps, "
          f"{', '.join(f'{x:.2f}' for x in c2['epoch_seconds'])} s an epoch, Pillow "
          f"{c2['pillow'] or 'not found'}; GIMMVFI_F step {f2['step_ms']:.2f} ms, peak "
          f"{f2['peak_bytes'] / 2**20:.1f} MiB; the windowed recipe step {w2['step_ms']:.2f} ms "
          f"(the backward kernel {fmt_ms(wa['device_ms'])} device a launch at the AMT lookup, "
          f"{wa['bound_ms']:.4f} ms bound, yardstick {fmt_ms(wa['library_ms'])} by events), "
          f"gradients against the materialized step "
          f"{w2['vs_materialized']['grad_rel_l2']:.2e} relative L2; {smi}", flush=True)
    d13 = p13["step"]
    print(f"[13] data-parallel training: the recipe step through one NCCL rank "
          f"{d13['step_ms']:.2f} ms against phase 12 (a)'s {s2['step_ms']:.2f}, peak "
          f"{d13['peak_bytes'] / 2**20:.1f} MiB, NCCL device "
          f"{fmt_ms(sum(d13['nccl_device_ms'].values()) if d13['nccl_device_ms'] else None)} a "
          f"step; {DP_WORLD} gloo ranks against one process: stage 1 loss "
          f"{p13['ranks']['stage1_loss_rel']:.2e}, gradients "
          f"{p13['ranks']['stage1_grad_rel']:.2e} x max|g|, stage 2 gradients "
          f"{p13['ranks']['stage2']['grad_rel_l2']:.2e} relative L2; the CLI under torchrun "
          f"within {p13['cli']['metrics_rel']:.2e} of phase 12 (c); {smi}", flush=True)
    print(f"[14] spatial sharding on {SPATIAL_WORLD} gloo ranks of one card: "
          + "; ".join(f"({label}) {p14[label]['db']:.2f} dB, max-abs {p14[label]['max_abs_err']:.3e}, "
                      f"launches {p14[label]['launches'][0]}, peak a rank "
                      f"{max(p14[label]['peak_bytes']) / 2**20:.1f} MiB against "
                      f"{p14[label]['one_process_peak_bytes'] / 2**20:.1f}"
                      for label, *_ in SPATIAL_CASES)
          + f"; {p14['seconds']:.2f} s; {smi}", flush=True)
    t15 = p15["train"]
    print(f"[15] pipeline FLOPs, card = CPU at the small points: {json.dumps(p15['by_device'])}; "
          f"every path: "
          + "; ".join(f"{label} {x['flops']} ({x['achieved_tflops_per_s']:.2f} TFLOP/s, vs_baseline "
                      f"{x['vs_baseline']})" for label, x in p15["paths"].items())
          + f"; the training tool at {TRAIN_STEPS15} steps: stage 1 "
          f"{t15['stage1']['steps_per_sec']:.3f} steps/s, stage 2 "
          f"{t15['stage2']['steps_per_sec']:.3f} steps/s; {p15['seconds']:.2f} s; {smi}",
          flush=True)
    print(f"[16] remat: "
          + "; ".join(f"{k} {v['plain_step_ms']:.2f} ms and {v['plain_peak_bytes'] / 2**20:.1f} MiB "
                      f"off, {v['remat_step_ms']:.2f} ms and {v['remat_peak_bytes'] / 2**20:.1f} "
                      f"MiB on" for k, v in p16["recipes"].items())
          + f"; stage 2 R with remat at batch {t16['batch']}, {t16['side']}x{t16['side']} (the "
          f"AMT windowed): {t16['step_ms']:.2f} ms a step, peak {t16['peak_bytes'] / 2**20:.1f} "
          f"MiB, its 2 windowed backward calls {sum(t16['bwd_ms']):.4f} ms by events; "
          f"{p16['seconds']:.2f} s; {smi}", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
