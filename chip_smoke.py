#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``hgsfusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--phases NAME[,NAME...]]

Phases, each of which must pass or the script exits non-zero (``--phases``
runs card, build and the named ones only, by the names printed in brackets;
an unknown name exits non-zero; the ``kernels`` line then holds the rows
and launches of what ran):

1. card: the ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` of every CUDA kernel (one process per source, all
   started together);
3. kernel vs plain: ``quad_sample_fwd`` (the taps computed in the kernel
   from (u, v) read in place, the unpadded map) against its plain PyTorch
   version at both flagship shapes (the flagship frustum grid's (u, v) read
   in place), a small ragged shape with out-of-bounds coords, odd channels,
   a map that is not 16-byte aligned, coordinates on and around every edge
   and coordinates wholly outside the map (all-zero output), in bf16 (atol
   0.04) and f32 (atol 1e-5); the idx and w4 it writes for the backward
   bit for bit against ``quad_indices``, its output without them and
   through the autograd entry bit for bit; the kernel's time with and
   without idx/w4 beside its memory bound, the route's (the autograd entry
   under ``no_grad`` and with the map requiring grad), the plain version's
   and ``F.grid_sample``'s (a yardstick the port never calls);
4. kernel vs plain, backward: ``quad_sample_bwd`` (with its bins,
   ``quad_bins``) against its plain version at the same flagship shapes, the
   ragged shape, a contention shape (every query on one 2x2 patch) and a hot
   tile (most of 1M queries on three pixels of a map of B's size), the last
   two in exact arithmetic and compared bit for bit, in bf16 and f32
   (tolerances at ``bwd_case``); at the flagship shapes two calls compared
   bit for bit, the bins' and the kernel's times and their sum beside the
   bound, the contention statistics, the plain version's time and
   ``aten.grid_sampler_2d_backward``'s (a yardstick);
4a. taps: the fused kernel's own tap computation (``quad_sample_taps``)
   against ``quad_indices`` bit for bit, bf16 and f32, at the flagship grid
   read in place (both maps), ragged coordinates and coordinates on, beside
   and just beyond every edge;
4b. kernel vs plain, fused reduce: ``quad_sample_reduce_fwd`` (the taps
   computed from the grid's (u, v) read in place, both gather groups'
   unpadded maps and the reduce product in one launch, output in the
   compute dtype) against its plain version at the flagship groups (both
   maps, the flagship grid, the (256, 128) reduce kernel, a random bias) in
   bf16 and f32 and a ragged case (three groups, odd channels and outputs,
   222 queries); tolerances at ``reduce_case``; in bf16 also against the
   sampling route a training step takes (``quad_sample_fwd`` +
   ``matmul_f32``) cast to bf16; the kernel's time beside its bound and
   the taps' L2 traffic, that route's, the plain version's
   and the library pair's (``F.grid_sample`` + ``torch.matmul``: no single
   PyTorch call computes the function, so ``library_ms`` is null);
4c. kernel vs plain, NMS: the op ``hgsfusion::nms_lazy`` (two launches per
   batch: ``nms_mask``, the pairwise suppression mask on every SM, then
   ``nms_sweep``) against ``greedy_nms_lazy_plain`` at the configs' 4,096
   candidates and threshold 0.01: clustered boxes all valid (500 kept), the
   trained-model regime (64 valid), two frames in one launch, duplicated /
   touching / nested / zero-area boxes, no valid candidate, ``max_keep``
   cuts at 37 and 64, and 8,192 candidates; every keep decision checked
   against the greedy rule with the plain IoU given the kernels' own
   history (``check_nms_frame``: a difference only at an IoU within NMS_TIE
   of the threshold, counted and printed), the keep sets compared; the
   mask's bits against ``nms_mask_plain`` where the sweep reads them (a
   difference only at such a tie), the sweep against ``nms_sweep_plain`` on
   the kernel's mask bit for bit; the op and each kernel (graph replays),
   the plain versions and ``class_agnostic_nms`` with each, timed beside
   the operations bound of this input's greedy circle tests and IoU
   evaluations, and the mask's own pairs;
5. small reference: the TINY test model on the card (kernel) against the same
   weights on the CPU (plain sampler), f32 with TF32 off, head outputs and
   post-processed boxes;
6. small reference, training: one training step of the TINY model (its
   backbone's residual scales at 0) on the card (kernels) against the same
   step on the CPU (plain versions), f32 with TF32 off: loss terms,
   gradients, updated parameters and BN statistics (tolerances in
   ``hgsfusion_tpu_torch/train/step_compare.py``);
7. serve: ``configs/hgsfusion_vod_pallas.yaml`` at full width (ResNet-101 at
   516x1936, 320x320x31 voxels, 8192 radar points) with random weights from a
   seed, one warm-up frame, then 3 frames in bf16 with the launch counters at
   0 before and 1 fused launch and 1 NMS (mask and sweep) per frame after (no other
   launch, no bins built); per-stage times, frames/s, peak device memory
   and the post-process with every candidate valid (timed; one call with
   ``torch.cuda.set_sync_debug_mode("error")``: no host read);
8. train: the same config and batch with its ``gt_boxes``, one warm-up
   training step, then 3 steps with the counters at 0 before and
   ``GATHER_STEP`` after (REMAT on: 4 forward, 2 backward, 4 bins); finite
   losses, a positive anchor, the frozen backbone bit-identical, every other
   trainable tensor moved, the backbone's BN statistics moved, no host sync
   in a step; step times, peak memory, loss terms and the device time by
   kernel of one profiled step;
9. kernel vs plain, polar: both kernels (the backward with its bins) against
   their plain versions at the polar view's three maps, 128 channels (the
   two reduced maps sampled by the near-field grid's (u, v) read in place,
   the polar table sampled by pass 3's clamped coordinates, from the
   flagship geometry), bf16 and f32 at the tolerances above, each call's
   time beside its bound (the forward as in 3);
10. small reference, polar: the TINY model with ``F2V.VIEW: polar`` on the
    card against the CPU, as 5, then one training step as 6;
11. polar vs gather: full width, f32, TF32 off, one set of weights: the
    polar image BEV's first ``POLAR_NEAR_COLUMNS`` columns (the exact near
    field) against the gather path's within 2e-3 of its largest value; the
    far field's correlation and relative L2 printed, not gated;
12. serve polar: ``configs/hgsfusion_vod_polar.yaml`` as 7, with 3 forward
    launches per frame (two near-field maps, pass 3) and no fused one;
13. train polar: as 8, with 3 forward, 3 backward and 3 bins per step;
14. small reference, eval loop: the TINY model through
    ``hgsfusion_tpu_torch.tools.test.run_eval`` over a 4-frame synthetic
    VoD tree, on the card (kernel) against the CPU (plain sampler), f32 with
    TF32 off, at a score threshold no two passing scores of a frame sit
    near: the same frame ids, boxes within 1e-4, the result dict within 1e-6;
15. eval: ``configs/hgsfusion_vod_pallas.yaml`` (read with ``load_config``:
    the card's machine has PyYAML, and Pillow for the JPEG images) over a
    8-frame synthetic VoD tree at 516x1936 written in a temporary directory
    (``structured=True``, 2048 radar and 4096 virtual points under the
    config's ``VIRTUAL_POINT_PREFIX``), its infos from the port's
    ``create_infos``, then ``run_eval`` at B=1 with random weights from seed
    0 (``SCORE_THRESH`` lowered so that about 12 candidates of a frame pass:
    random weights score every anchor under 0.1) after one warm-up frame:
    some boxes kept, the counters at 0 before and 1 fused launch per frame
    after (no other launch, no bins), every frame's
    annotations bit-equal to those of ``serve`` on the same collated batch,
    finite recall counts and result dict, every AP in [0, 100]; printed: the
    pipelined and the ``serve``-only ms per frame, the host ms per frame of
    each stage, the evaluation's seconds and peak device memory;
16. eval polar: ``configs/hgsfusion_vod_polar.yaml`` as 15, with 3 forward
    launches per frame;
17. small reference, XLA sampler: the TINY model with
    ``f2v_sampler_kernel="xla"`` on the card against the CPU, as 5 and 6,
    with the kernels launched on the card (1 fused in the served frame, 4
    forward, 2 backward and 4 bins in the step, REMAT on);
18. train CLI: ``configs/hgsfusion_vod.yaml`` (``SAMPLER_KERNEL: xla``, read
    with ``load_config``) at full width through
    ``hgsfusion_tpu_torch.tools.train.main`` over a 16-frame synthetic tree
    (as 15), ``--fix_random_seed --epochs 2 --max_steps 20 --workers 4``:
    the counters at 0 before and 4 forward, 2 backward and 4 bins per step
    after, finite losses, some frame flipped and some frame with a
    ``lidar_aug_matrix`` other than the identity among those fed,
    checkpoints at steps 16 and 20 only; then a resume with ``--max_steps
    4`` from step 20 whose model and optimizer state equal the file bit for
    bit before its first step, ending at step 24 (one step profiled); then
    ``tools.test.main --ckpt_dir ... --max_frames 4`` on step 24, 1 fused
    launch per frame. Printed: steps/s after the first two steps, the
    loader wait per step, the profiled step's device time, each save's and
    the resume's seconds, the checkpoint's bytes and peak device memory;
19. kernel vs plain, scatter: ``row_scatter_add`` (with its binning)
    against ``row_scatter_add_plain`` at the four tables of
    ``_bench_scatter_pallas.py`` (3,174,400 bf16 rows, each tile of 2048
    inside a window of 2048 table rows): random rows (timed: the kernel
    with its binning, the binning, the kernel alone, the plain version and
    ``index_add_``, beside the bound) and integer-valued rows compared bit
    for bit; then a ragged case (37 channels, negative and out-of-range
    indices, one row receiving every update); tolerances at
    ``scatter_case``; every case two calls bit for bit;
20. bench scatter: P5's entry point, ``hgsfusion_tpu_torch.bench_scatter``,
    on BENCH_SCATTER_CASES: the kernel launched 12 times a case;
21. small reference, TJ4D: the TINY TJ4D model (``tiny_tj4d_cut`` of
    ``configs/hgsfusion_tj4d_pallas.yaml``: 4 classes, 8 anchors, 18 point
    features, a 32 x 40 x 6 grid) over a 4-frame synthetic TJ4D tree, card
    vs CPU: two frames served (as 5), one B=2 training step on two
    augmented frames (as 6), the eval loop (as 14);
22. serve TJ4D: ``configs/hgsfusion_tj4d_pallas.yaml`` at full width
    (810x1280, 216 x 248 x 19 voxels) as 7 on ``tj4d_serve_batch``, 1
    fused launch per frame;
23. serve TJ4D polar: ``configs/hgsfusion_tj4d_polar.yaml`` as 22, 3
    forward launches per frame;
24. train CLI, TJ4D: ``configs/hgsfusion_tj4d.yaml`` (``SAMPLER_KERNEL:
    xla``, ``BATCH_SIZE_PER_DEVICE: 2``) through ``tools.train.main`` over a
    16-frame synthetic TJ4D tree, 10 steps across an epoch boundary: 4
    forward, 2 backward and 4 bins per step, checkpoints at steps 8 and 10,
    step 1 profiled; then ``tools.test.main --ckpt_dir`` over 4 frames, 1
    fused launch per frame, TJ4D's result dict with every AP in [0, 100];
25. eval TJ4D polar: ``configs/hgsfusion_tj4d_polar.yaml`` as 15 over a
    8-frame synthetic TJ4D tree, 3 forward launches per frame;
25a. export and serve: ``configs/hgsfusion_vod_pallas.yaml`` and
    ``configs/hgsfusion_vod_polar.yaml`` at full width exported by
    ``tools/export.py``'s ``export_model`` (the fused kernel, or the
    forward three times, and the NMS as ops in the graph) and saved; export
    and save seconds, the artifact's bytes, ms per frame by completion gaps
    through ``serve`` and through the artifact in this process; then every
    export phase's artifact served by ``tools/serve.py`` in a subprocess
    that blocks the model code and JAX (``SERVE_GUARD_RUNS``), one run each
    over 6 ``.npz`` files (3 flagship frames, each twice): these four
    artifacts by a host started right after them (``serving_host_start``,
    which runs while the later phases do, so its ms a frame share
    the card with them), the CLI exports' by one more in the
    ``serving_host`` phase, the last, which checks both: each run's
    launches must read the view's per frame, its detections equal
    ``serve``'s (valid and labels, boxes and scores within 1e-4) at a
    tie-free score threshold, its ms per frame by completion gaps beside
    ``serve``'s;
25b. bench: the port's ``bench`` entry point (``bench.main`` in this
    process, as ``python -m hgsfusion_tpu_torch.bench`` runs it) for the
    polar default, ``--vod``, ``--realistic`` and ``--tj4d``: exactly one
    JSON line each, its metric named as ``bench.py`` names it, a positive
    value, the timed calls' launches;
26. small reference, RHGM: the segmentor's tiny preset with either pixel
    decoder (weights from one seed) on a 70 x 100 image, on the card against
    the CPU in f32 with TF32 off: logits and mask logits within
    ``RHGM_TOL``, then ``instance_inference`` (``compare_instances``: labels,
    scores and binary masks rank by rank where the ranks are tie-free, a
    flipped mask pixel only where the CPU's logit lies within ``RHGM_TOL``
    of 0);
27. RHGM: the port's ``tools/generate_hybrid_points.py`` (``main``) on a
    3-frame synthetic VoD tree at 516 x 1936 (2048 radar points a frame):
    ``--mask_source model --model_preset large --pixel_decoder msdeform
    --resize_shortest 1024`` (swin-L Mask2Former on 1024 x 3842, random
    weights from seed 0) with ``--confidence_threshold 0.0``, since random
    weights score no instance near the default 0.5 and the generator would
    do nothing; every frame with virtual and real points; then the
    precomputed source on the first run's masks (``.npz``): the same files
    byte for byte; the VoD dataset (``configs/hgsfusion_vod.yaml``) reads
    them under its ``VIRTUAL_POINT_PREFIX``, 15 wide, virtual rows in every
    frame; then one TJ4D frame (810 x 1280 PNG, 8 radar dims) through the
    model source at the tool's own size: 16 wide. No kernel counter moves.
    Printed per frame: the segmentor's ms (to a device synchronize), the
    masks' copy and the host generator's ms, the masks kept, the virtual and
    real points; frames/s through the tool after the warm-up frame, peak
    device memory, and the segmentor's FLOPs (``torch.utils.flop_counter``)
    over the f32 peak as its bound;
28. ddp: ``configs/hgsfusion_vod.yaml`` at full width through the
    data-parallel step (``parallel/mesh.py``: DDP, the synchronized
    BatchNorms): (a) world size 1 over NCCL in this process, two steps, bit
    for bit the plain step (cuDNN deterministic; held to the plain step's
    own run-to-run spread if that is not 0), 4 forward, 2 backward and 4
    bins a step; (b) two ranks on the card over gloo (``spawn_ranks``) at
    B=1 each against one process at B=2 on the same two flagship frames,
    in f32 with TF32 off, and the TINY model likewise, each under the whole
    ``train/step_compare.py`` comparison (loss terms, gradients, updated
    parameters, BN statistics), the tensors that its 8 probes find over
    ``SENS_CAP`` named and exempted (every weight seed leaves some tensor
    ill-conditioned at full width: ``ddp_conditioning``, ``ddp_noise``);
    the ranks bit-equal, each rank's step 4 + 2 + 4 launches;
29. eval multiproc: ``tools.test.main`` over a 5-frame full-width VoD tree
    in this process and in two gloo ranks (the second shard padded with
    frame 0), gather and polar views: the merged ``result.pkl`` and every
    rank's result dict equal one process's, each rank serving 3 frames;
30. tta: ``tools/test_tta.py`` with ``--tta_num 4`` over a 2-frame
    full-width VoD tree, both views: 1 fused + 1 NMS or 3 forward + 1 NMS
    launches a variant, every variant's annotations equal ``serve`` on it;
31. study small: ``study_gpu.sh``'s plumbing: ``tools/make_study_data.py``
    (VoD, 516 x 1936, 4 train / 2 val frames), 4 steps of
    ``tools/train.py`` under ``torchrun --nproc_per_node 1`` (NCCL; its
    launches read from the log), ``tools/test.py`` on the checkpoint
    through each view, ``tools/study_polar_match.py`` on the two results;
32. depth kernels: ``quad_sample_depth_fwd`` and ``quad_sample_depth_bwd``
    (USE_DEPTH's depth-weighted frustum sample and the gradient of its
    distribution) against their plain versions at the VoD gather maps (80
    bins, the flagship grid read in place) in bf16 and f32, a ragged case
    and a hot pixel whose taps' pixels the backward splits into many chunks
    (``depth_case`` states the tolerances; the keys bit for bit, two
    backward calls bit for bit), each timed beside its bound, its plain
    version and the library (``F.grid_sample`` 5-D on the built volume;
    ``aten.grid_sampler_3d_backward`` plus the contraction over C), and the
    entry visits per pixel as a histogram (the backward's split by kernel:
    ``compare_kernels_parent.py``);
33. serve depth: the TINY depth model card vs CPU (serving, the depth
    logits included), then
    ``hgsfusion_tpu_torch/configs/hgsfusion_vod_depth.yaml`` at full width
    as 7: 2 depth-weighted forward launches and 1 NMS a frame;
34. train depth: that config as 8 with the DDN term (``depth_targets``),
    REMAT on (4 depth forward, 2 backward, 4 bins, 2 depth backward a step)
    and off (2, 2, 2, 2) from the same weights: the first step's loss terms
    bit for bit and its gradients within ``GRAD_RTOL``, the next three's
    loss terms within ``LOSS_AFTER_UPDATE_RTOL``; step times and peak memory
    of each; the frozen backbone leaves only its taps allocated;
35. train CLI depth: ``tools.train.main`` on that config over a 4-frame
    full-width tree with each of ``adam_onecycle``, ``adam`` and ``sgd``: 2
    steps, a resume bit for bit, one more step; ``tools.test.main
    --ckpt_dir`` on the last run (2 depth forward + 1 NMS a frame);
36. export and serve depth: as 25a on that config;
37. kernel vs plain, q8: F2V QUANT int8's K1 on the int8 map
    (``quad_sample_q8_fwd``) against ``quad_sample_q8_plain`` at both VoD
    gather maps (per-channel int8 of random maps, the flagship grid read in
    place) in bf16 and f32 and a ragged case (``q8_sample_case`` states the
    tolerances: one bf16 ulp and 1e-5 of the taps' magnitude; idx/w4 bit for
    bit); its P3 (``quad_sample_reduce_q8_fwd``) against
    ``quad_sample_reduce_q8_plain`` at both groups in one launch and a ragged
    case, at ``reduce_case``'s tolerances; each timed beside its bound, the
    plain version and (K1-q8) ``F.grid_sample``;
38. kernel vs plain, w8a8: ``conv2d_w8a8`` (which quantizes its own input)
    against its plain version, exactly equal in f32 and bf16, at each of the 23
    distinct convolutions of the VoD ResNet-101 (``backbone_conv_shapes``, 104
    in all) on random activations with exact rounding midpoints
    (``w8a8_input``); its first pass alone (``quantize_int8``, the stem's
    ``im2col_int8``) equal to its plain version, ``activation_scale`` bit for
    bit the parent's formula and the op equal to the parent's route, on
    served-like activations; ragged cases at every tile width; each timed (the
    kernel, its first pass, the route with ``activation_scale``) beside its
    bound (int8 operations or bytes, x read in bf16; and read as int8), the
    plain version, cuDNN's bf16 ``F.conv2d`` and ``torch._int_mm`` on im2col
    columns (yardsticks), and the sums over the backbone;
39. serve q8: ``hgsfusion_tpu_torch/configs/hgsfusion_vod_q8.yaml`` as 7:
    one P3-q8 and one NMS launch a frame;
40. train q8: that config as 8 (REMAT on): 4 K1-q8, 2 K2 and 4 bins a step;
41. eval q8: that YAML as 15 over 4 frames, 1 P3-q8 a frame;
42. export and serve q8: as 25a on that config;
43. serve w8a8: ``hgsfusion_vod_w8a8.yaml`` as 7 in the gather view (104
    int8 convolutions, 1 P3-q8, 1 NMS a frame) and in the polar view (F2V
    QUANT none: 104, 3 forward, 1 NMS);
44. occupancy v2: the TINY parallel-ASPP model (DCN branch, SE gate) card
    vs CPU as 5, then ``hgsfusion_vod_occ_v2.yaml`` served as 7 (1 fused, 1
    NMS a frame) and trained as 8 (4, 2, 4 a step);
45. small reference, radar-only and PointPillars multi-head: the TINY
    radar-only model (``RadarOnlyModel`` over TINY's range, no image) and
    the multi-head PointPillars model (``configs/pp_multihead_nuscenes.yaml``
    cut to a 16 x 16 m range: 80 x 80 pillars, 32,000 anchors) built
    through ``build_network``, card vs CPU: head outputs within 1e-4, the
    post-processing (class-agnostic; per head and class, the sets stacked
    in one NMS call) on tie-broken scores, one training step under
    ``step_compare`` (the multi-head one from BN biases lifted by
    ``ZOO_BN_LIFT``: a plain 20-layer conv stack with random weights is
    ill-conditioned otherwise);
46. serve / train radar-only: ``configs/radar_pillar_vod.yaml`` at full
    width (f32: the config names no dtype; 8,192 points x 17 features,
    320 x 320 pillars, 614,400 anchors, top 4,096) served 3 frames at B=1
    (1 NMS, i.e. one mask and one sweep launch, a frame; no other kernel)
    and 3 training steps at B=1 (no kernel); device ms a frame and a step
    by CUDA events, peak memory, no host sync in a step;
47. train CLI radar-only: ``tools.train.main`` on that config over an
    8-frame synthetic VoD tree (the batches carry no image), then
    ``tools.test.main --ckpt_dir``, then the checkpoint exported by
    ``tools/export.py`` and served by the serving host (``SERVE_GUARD``):
    its detections equal ``serve``'s at a tie-free threshold;
48. serve / train PointPillars multi-head: ``configs/pp_multihead_nuscenes.yaml``
    at full width on ``synthetic.nuscenes_batch`` (327,680 points x 5,
    512 x 512 pillars, a 256 x 256 head map, 6 heads, 10 classes, 1,310,720
    anchors, 128 gt boxes with velocity): served at B=1 (the 10 per-class
    sets of a frame in one NMS call), trained at B=4; the pillar
    scatter-max (PyTorch's ``scatter_reduce``) timed beside its bytes bound;
49. demo: ``tools/demo.py`` on a 2-frame full-width VoD tree with
    ``configs/radar_pillar_vod.yaml`` and ``configs/hgsfusion_vod.yaml``,
    ``--html``: every frame served (radar: 1 NMS; HGSFusion: 1 fused + 1
    NMS), the HTML written; the PNGs where matplotlib is installed (printed);
50. depth kernels at BEVFusion's shapes: D1 (``quad_sample_depth_fwd``),
    D2 (``quad_sample_depth_bwd``) and K2 (``quad_sample_bwd`` on D1's
    effective weights) against their plain versions on the FPN's reduced
    map (65 x 242 x 64, 80 bins) at the camera grid (B, 40, 40, 25, 3) read
    in place, B=1 (timed; f32 and bf16) and B=2 (f32, bf16);
51. small reference, BEVFusion: the TINY BEVFusion (small Swin) card (D1)
    vs CPU: heads within 1e-4, proposals matched by class and cell and
    ranked alike wherever no score lies within 1e-5 of a neighbour's;
52. serve BEVFusion: ``configs/bevfusion_vod.yaml`` (f32, Swin-T +
    GeneralizedLSSFPN, the depth-lifted camera BEV, the dense-masked
    VoxelBackBone8x on 51 x 320 x 320 voxels, ConvFuser, TransFusion head,
    200 proposals) served 3 frames at B=1 (1 D1 a frame) with stream, wall,
    profiled device ms and peak memory, then ``bench.main(["--bevfusion"])``;
53. train BEVFusion: 3 B=1 steps after a warm-up (2 D1, 2 bins, 1 K2, 1
    D2 a step; stochastic depth on; the one host read of the Hungarian
    costs the only sync), every trainable tensor with a gradient moved;
54. train CLI BEVFusion: ``tools.train.main`` over an 8-frame full-width
    VoD tree (4 steps), then ``tools.test.main --ckpt_dir`` on 4 frames;
55. serve TransFusion-L: ``configs/transfusion_vod.yaml`` (pillars, head at
    160 x 160) served as 52 (no kernel), then ``bench --transfusion``;
56. train CLI TransFusion-L: that config through ``tools.train.main`` and
    ``tools.test.main --ckpt_dir`` as 54 (no kernel);
57. nms center: ``nms_lazy`` against its plain version at the center
    families' shapes (the decode's 500 candidates at 0.01, B=1 and B=2, a
    tenth valid; the nuScenes CenterPoint's 500 at 0.2, 83 kept): equal keep
    sets, timed beside the bound;
58. small reference, center families: CenterPoint (classic and res2d),
    SECOND, VoxelNeXt and VoxelNeXt2D cut to TINY (``tiny_center``), card vs
    CPU: heads within 1e-4, the post-processing of the CPU's heads (scores
    untied by a ramp) equal on both devices, one NMS call on the card;
59. serve the center families and SECOND (``CENTER_ZOO``:
    ``configs/centerpoint_vod.yaml``, ``centerpoint_pillarres2d_vod.yaml``,
    ``second_vod.yaml``, ``voxelnext_vod.yaml``, ``voxelnext2d_vod.yaml``)
    at full width on ``flagship_batch``, and ``centerpoint_nuscenes.yaml``
    on ``nuscenes_batch``: 3 frames at B=1 (one NMS call each, no other
    kernel), stream, wall and profiled device ms, peak memory, as 52; then
    ``bench.main(["--<name>"])`` for each VoD one;
60. train CenterPoint, SECOND and VoxelNeXt at B=1 and the nuScenes
    CenterPoint at B=4 as 46: 3 steps after a warm-up, no kernel, every
    trainable tensor with a gradient moved, no host sync, the 3-D
    convolutions' tap products a step;
61. train CLI CenterPoint and SECOND: as 54, one NMS call a frame;
62. nms twostage: ``nms_lazy`` against its plain version at the two-stage
    shapes: the proposal layer's 512 candidates at 0.8, 128 kept (B=1
    timed, B=2), and SECOND-IoU's final 128 proposals at 0.01: equal keep
    sets, timed beside the bound;
63. ball query: ``configs/voxelrcnn_vod.yaml`` on the flagship batch, its
    128 proposals' 27,648 RoI grid points over x_conv2, x_conv3 and
    x_conv4 (``ops/pointnet2.py::ball_query_grid``, the windowed query)
    timed; its index lists equal to the dense query's exactly on 216,
    864 and all 27,648 points of the three stages;
64. focal backbone: VoxelBackBone8xFocal beside VoxelBackBone8x in eval
    mode at full width (device ms, the focal layers' active sites);
65. small reference, two-stage: the focal SECOND, SECOND-IoU, Voxel R-CNN,
    PV-RCNN, PV-RCNN++ and Part-A2 cut to TINY (``tiny_twostage``), card vs
    CPU: RPN maps within 1e-4 (the focal importances spread by ``spread_importances`` and
    checked tie-free by ``focal_premise``), the proposals of the CPU's
    ramped RPN maps equal on both devices, the second stage on them
    within 1e-4 (the keypoints equal), the post-processing equal (1 or 2
    NMS calls, and PV-RCNN's FPS), one training step on the card (finite
    terms; one NMS call for the two-stage families, one FPS for PV-RCNN's);
66. serve the focal SECOND, SECOND-IoU and Voxel R-CNN
    (``configs/second_focal_vod.yaml``, ``second_iou_vod.yaml``,
    ``voxelrcnn_vod.yaml``) at full width as 59 (1, 2 and 2 NMS calls a
    frame), then ``bench.main(["--<name>"])``; train each at B=1 as 60
    (0, 1 and 1 NMS calls a step); train CLI Voxel R-CNN and SECOND-IoU as
    54 (1 NMS call a step, 2 a frame), each checkpoint then exported by
    ``tools/export.py`` and served by the serving host of 25a on 3
    evaluation frames (2 NMS calls a frame; detections equal ``serve``'s);
67. fps: ``hgsfusion::farthest_point_sample`` (``csrc/fps.cu``) against its
    plain version at PV-RCNN's 8,192 points -> 1,024 keypoints: B=1 and
    B=2, 16,384 points and a proposal-centric mask (timed beside the bound
    and the chain floor, ``tune_fps.CHAIN_FLOOR``, with the cluster size),
    exact ties, fewer valid points than keypoints; the indices equal;
68. PV-RCNN and PV-RCNN++ (``configs/pvrcnn_vod.yaml``,
    ``pvrcnnpp_vod.yaml``): served at full width as 59 (2 NMS calls and 1
    FPS a frame; the FPS, the voxel set abstraction, the keypoint weighting
    and the RoI-grid pool timed alone) and ``bench``; trained at B=1 as 60
    (1 NMS and 1 FPS a step; the gather backward's device ms); PV-RCNN
    through the CLIs and exported as 66 (1 + 1 a step, 2 + 1 a frame, the
    serving host equal to ``serve``);
69. Part-A2 (``configs/parta2_vod.yaml``): in 65 at TINY (its point head
    and second stage within 1e-4, its two RoI-aware pools on the CPU's
    inputs: the max bit for bit, the mean within f32 rounding); served at
    full width as 59 (2 NMS calls a frame; the UNet decoder, the points'
    features, the point head, the pools' cells, the max and mean pools and
    the RoI head timed alone) and ``bench``; trained at B=1 as 60 (1 NMS
    call a step; the max pool's forward and backward timed on
    ``parta2_pool_inputs``, the decoder's tap products); through the CLIs
    and exported as 66.

4c also holds the NMS kernels to the multi-head regime: 10 and 40 sets
(a frame, and B=4) of 1,000 nuScenes-sized candidates at IoU 0.2, 83 kept;
57 to the center families' (the NMS rows' ``center`` block), 62 to the
two-stage families' (``twostage``).

The ``kernels`` line counts each kernel's launches over the main paths
(``MAIN_PATHS``: 7, 8, 12, 13, 15, 16, 18's three runs, 20, 22-25, 25a's
serving host runs, 27, 28-31, 33-36, 39-44, 46-49, 52-56, 59-61, 66, 68 and 69,
the ranks' launches summed),
each path's count taken with the counters at 0 just before it; the
forward's row also carries ``route_ms``, its autograd entry's time. The last lines are the
``kernels`` JSON line, the ``nvidia-smi`` line and ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from hgsfusion_tpu_torch import bench, bench_scatter, native
from hgsfusion_tpu_torch.config import (HGSFusionConfig, load_config, model_config_from_yaml,
                                        vod_dataset_config, vod_pallas_config, vod_polar_config)
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import (make_calib, make_synthetic_kitti,
                                                    make_synthetic_tj4d)
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import (BEVFusionModel, HGSFusionModel, PartA2Model,
                                                 multihead_candidate_sets, post_process)
from hgsfusion_tpu_torch.models.layers import MaskedBatchNorm
from hgsfusion_tpu_torch.models.registry import build_network
from hgsfusion_tpu_torch.models.frustum import FrustumGridGenerator
from hgsfusion_tpu_torch.models.layers import resize_bilinear
from hgsfusion_tpu_torch.models.polar_f2v import polar_geometry
from hgsfusion_tpu_torch.models.resnet import ResNetDeepLabBackbone, preprocess_images
from hgsfusion_tpu_torch.models.transfusion_head import TransFusionHead
from hgsfusion_tpu_torch.models.pvrcnn import roi_grid_points, stage_point_set
from hgsfusion_tpu_torch.ops.roiaware_pool import pool_cells, roiaware_cells
from hgsfusion_tpu_torch.models.voxel_backbone import (SparseConv3d, height_compression, mean_vfe,
                                                       points_to_voxel_ids)
from hgsfusion_tpu_torch.ops import (conv_int8, depth_sample, library, nms, pointnet2,
                                     quad_sample, row_scatter)
from hgsfusion_tpu_torch.ops.grid_sample import (div_exact, quad_sample_bwd_plain,
                                                quad_sample_fwd_plain, quantize_per_channel_int8)
from hgsfusion_tpu_torch.ops.matmul import matmul_f32
from hgsfusion_tpu_torch.ops.pointnet2 import ball_query, ball_query_grid, window_span
from hgsfusion_tpu_torch.ops.rotated_iou import boxes_iou_bev
from hgsfusion_tpu_torch.parallel import mesh, spawn
from hgsfusion_tpu_torch.rhgm.mask2former import Mask2FormerInstance, instance_inference
from hgsfusion_tpu_torch.ops.voxelize import points_to_pillar_ids, scatter_max_dense
from hgsfusion_tpu_torch.synthetic import LIDAR_TO_CAM, flagship_batch, nuscenes_batch
from hgsfusion_tpu_torch.tools import export as export_cli
from hgsfusion_tpu_torch.tools import demo as demo_cli
from hgsfusion_tpu_torch.tools import generate_hybrid_points as ghp
from hgsfusion_tpu_torch.tools import make_study_data
from hgsfusion_tpu_torch.tools import serve as serve_cli
from hgsfusion_tpu_torch.tools import study_polar_match as study_match
from hgsfusion_tpu_torch.tools import test as test_cli
from hgsfusion_tpu_torch.tools import test_tta as test_tta_cli
from hgsfusion_tpu_torch.tools import train as train_cli
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.tools.test import run_eval
from hgsfusion_tpu_torch.train.checkpoint import CheckpointManager
from hgsfusion_tpu_torch.train.optim import FROZEN_PREFIX, build_optimizer
from hgsfusion_tpu_torch.train.step_compare import (GRAD_RTOL, SENS, SENS_CAP, ZERO_FLOOR,
                                                    GradCapture, compare_steps, over_cap,
                                                    perturb_inputs, sensitivity, step_record,
                                                    zero_residual_scales)
from hgsfusion_tpu_torch.train.trainer import (detections_to_pred_dicts, make_train_step,
                                               make_train_step_for_cfg)
from hgsfusion_tpu_torch.utils.common import create_logger

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense, tensor cores
KERNEL_SOURCES = ["quad_sample", "quad_sample_bwd", "quad_sample_reduce", "row_scatter_add",
                  "nms_lazy", "quad_sample_depth", "conv_int8", "fps"]
BF16_TOL, F32_TOL = 0.04, 1e-5
F32_U = 2.0 ** -24  # f32 unit round-off
# the two gathers of a frame: layer1 (64 ch at /4), layers 2-4 (192 ch at /8)
FLAGSHIP_SHAPES = {"A": (1, 129, 484, 64), "B": (1, 65, 242, 192)}
FLAGSHIP_QUERIES = 320 * 320 * 31
# the view transform's reduce: sum of the groups' channels (256) to 128
# outputs; the fused kernel against its plain version: f32 order bounds (see
# reduce_case)
REDUCE_O = 128
REDUCE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# the optimizer's schedule length in the training phases (a short OneCycle)
TRAIN_TOTAL_STEPS = 100
# the weights of the small training reference: a seed whose step the CPU's
# own probes find well conditioned (step_compare.SENS_CAP)
TRAIN_REF_SEED = 3


def tiny_batch(b: int = 1, n: int = 128):
    """tests/test_model.py::make_tiny_batch with RandomState(0), gt boxes
    included."""
    rng = np.random.RandomState(0)
    pts = np.zeros((b, n, 17), np.float32)
    pts[..., 0] = rng.uniform(0.5, 15.5, (b, n))
    pts[..., 1] = rng.uniform(-7.5, 7.5, (b, n))
    pts[..., 2] = rng.uniform(-2.5, 1.5, (b, n))
    pts[..., 3:15] = rng.randn(b, n, 12).astype(np.float32)
    pts[..., 15] = (rng.rand(b, n) > 0.5).astype(np.float32)
    pts[..., 16] = 1.0
    return {
        "points": pts,
        "points_valid": np.ones((b, n), bool),
        "images": rng.rand(b, 64, 96, 3).astype(np.float32),
        "trans_lidar_to_cam": np.tile(np.array(LIDAR_TO_CAM, np.float32), (b, 1, 1)),
        "trans_cam_to_img": np.tile(np.array(
            [[80.0, 0, 48, 0], [0, 80, 32, 0], [0, 0, 1, 0]], np.float32), (b, 1, 1)),
        "lidar_aug_matrix": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "gt_boxes": np.tile(np.array([[6.0, 1.0, -0.8, 3.9, 1.6, 1.56, 0.3, 1],
                                      [10.0, -2.0, -0.5, 0.8, 0.6, 1.73, -0.5, 2]]
                                     + [[0.0] * 8] * 6, np.float32), (b, 1, 1)),
    }


TINY = HGSFusionConfig(pc_range=(0.0, -8.0, -3.0, 16.0, 8.0, 2.0), voxel_size=(0.5, 0.5, 0.5),
                       image_size=(64, 96), disc_num_bins=16, disc_depth_max=16.0,
                       image_backbone="ResNet50", f2v_sampler_kernel="pallas")
TINY_POLAR = dataclasses.replace(TINY, f2v_view="polar", f2v_sampler_kernel="xla")
TINY_XLA = dataclasses.replace(TINY, f2v_sampler_kernel="xla")
# the polar view's three sampled maps at full width: the two reduced maps
# (128 channels) of the near field, and the polar table q (J = 128 zeta
# nodes, K = 484 + 6 u-nodes) of pass 3
POLAR_SHAPES = {"near_A": (1, 129, 484, 128), "near_B": (1, 65, 242, 128),
                "q": (1, 128, 490, 128)}
# the near field against the gather path: tests/test_polar_f2v.py's bound
NEAR_TOL = 2e-3


def zero_launches():
    for counters in (library.launches, row_scatter.launches):
        for k in counters:
            counters[k] = 0


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph, the mean over ``replays`` replays after a warm-up one, so that
    the host's pace of launching them is out of the timing (``cuda_ms``
    times calls as the host launches them). ``fn`` allocates from the graph's
    pool; its host side (a launch counter) runs once, at the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sampler_case(name, features, coords, dtype, tol, timed: bool):
    """``quad_sample_fwd`` (``coords`` read in place, the unpadded map)
    against its plain version on one input, at ``tol``; the idx and w4 it
    writes for the backward against ``quad_indices``' bit for bit; without
    them, and through the autograd entry, the same output bit for bit.
    ``timed``: the kernel's device time with and without idx/w4
    (``graph_ms``; ``calls_ms``: its calls back to back as the host launches
    them), the route (the autograd entry under ``no_grad`` and with the map
    requiring grad), the plain version and ``F.grid_sample``, beside the
    bound with and without idx/w4."""
    f = features.to(dtype)
    b, h, w, c = f.shape
    out, idx, w4 = library.quad_sample_fwd(f, coords, taps=True)
    bare = library.quad_sample_fwd(f, coords)[0]
    got = quad_sample.grid_sample_2d_quad_kernel(f, coords)
    torch.cuda.synchronize()
    ref, ref_idx, ref_w4 = quad_sample.quad_sample_fwd_uv_plain(f, coords, taps=True)
    err = float((out.float() - ref.float()).abs().max())
    n, isz = idx.numel(), f.element_size()
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "shape": [b, h, w, c], "queries": n, "uv_stride": coords.stride(-2),
           "max_abs_err": err, "tol": tol,
           "idx_equal": bool(torch.equal(idx, ref_idx)),
           "w4_equal": bool(torch.equal(w4, ref_w4)),
           "valid_queries": int((w4 != 0).any(dim=1).sum()),
           "bit_equal_without_taps": bool(torch.equal(out, bare)),
           "bit_equal_route": bool(torch.equal(got.reshape(n, c), out))}
    del bare, got, ref, ref_idx, ref_w4
    if timed:
        # each query's (x, y), the map once, the output once; idx and w4 on top
        nbytes = n * 8 + f.numel() * isz + n * c * isz
        ops = 8.0 * n * c  # four multiply-adds a channel
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S \
            else "operations"
        row["bound_taps_ms"] = max((nbytes + 20 * n) / HBM_BYTES_PER_S,
                                   ops / F32_FLOPS_PER_S) * 1e3
        row["bytes"] = nbytes
        # the kernel's device time (launches replayed from a CUDA graph), and
        # its calls back to back as the host launches them
        row["ms"] = graph_ms(lambda: library.quad_sample_fwd(f, coords))
        row["taps_ms"] = graph_ms(lambda: library.quad_sample_fwd(f, coords, taps=True))
        row["calls_ms"] = cuda_ms(lambda: library.quad_sample_fwd(f, coords), iters=50)
        with torch.no_grad():
            row["route_ms"] = cuda_ms(lambda: quad_sample.grid_sample_2d_quad_kernel(f, coords),
                                      iters=50)
        fg = f.detach().requires_grad_()
        row["route_grad_ms"] = cuda_ms(lambda: quad_sample.grid_sample_2d_quad_kernel(fg, coords),
                                       iters=50)
        row["plain_ms"] = cuda_ms(lambda: quad_sample.quad_sample_fwd_uv_plain(f, coords),
                                  iters=3, warmup=1)
        fmap = f.permute(0, 3, 1, 2).contiguous()
        # grid_sample takes the grid in the map's dtype
        g = coords.reshape(b, -1, coords.shape[-2], 2).to(dtype)
        row["library_ms"] = cuda_ms(lambda: F.grid_sample(
            fmap, g, mode="bilinear", padding_mode="zeros", align_corners=True), iters=50)
        row["bound_fraction"] = row["bound_ms"] / row["ms"]
    print("  " + json.dumps(row))
    if not err <= tol:
        raise AssertionError(f"{name} {row['dtype']}: max error {err} > {tol}")
    for key in ("idx_equal", "w4_equal", "bit_equal_without_taps", "bit_equal_route"):
        if not row[key]:
            raise AssertionError(f"{name} {row['dtype']}: {key} is false")
    return row


def flagship_grid(dev):
    """The flagship frame's sampling grid (1, 320, 320, 31, 3): (u, v, depth
    bin) as the view transform reads it."""
    cfg = vod_pallas_config()
    batch = flagship_batch(cfg)
    gen = FrustumGridGenerator(cfg.grid_size, cfg.pc_range, cfg.disc_cfg, cfg.bev_aug)
    return gen(*(torch.from_numpy(batch[k]).to(dev) for k in
                 ("trans_lidar_to_cam", "trans_cam_to_img")), cfg.image_size,
               bda=torch.from_numpy(batch["lidar_aug_matrix"]).to(dev))


def flagship_uv(dev):
    """The flagship frame's (u, v) sampling grid (1, 320, 320, 31, 2),
    contiguous."""
    return flagship_grid(dev)[..., 0:2].contiguous()


def outside_coords(dev, n: int = 600, seed: int = 13):
    """(2, n, 2) coordinates wholly outside a map of at least 2 x 2 pixels:
    x or y beyond 1.5 in magnitude (more than half the map's span past its
    edge), the other anywhere in -1.3 .. 1.3."""
    g = torch.Generator().manual_seed(seed)
    far = (torch.rand((2, n), generator=g) * 2.5 + 1.5) \
        * torch.where(torch.rand((2, n), generator=g) < 0.5, -1.0, 1.0)
    near = torch.rand((2, n), generator=g) * 2.6 - 1.3
    x_out = torch.rand((2, n), generator=g) < 0.5
    return torch.stack([torch.where(x_out, far, near), torch.where(x_out, near, far)],
                       -1).to(dev)


def unaligned(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.copy_(t.reshape(-1)).view(t.shape)


def phase_kernel_vs_plain(dev):
    """K1 at the VoD gather maps (the flagship grid's (u, v) read in place),
    a ragged case (two frames, 40 channels, coordinates beyond the maps),
    odd channels, a map that is not 16-byte aligned, coordinates on and
    around every edge and coordinates wholly outside the map, bf16 and f32;
    the gather maps and the ragged case timed."""
    uv = flagship_grid(dev)[..., 0:2]
    g = torch.Generator(device="cpu").manual_seed(1)
    cases = [(name, torch.randn(shape, generator=g).to(dev), uv)
             for name, shape in FLAGSHIP_SHAPES.items()]
    ragged = (torch.rand((2, 37, 3, 3), generator=g) * 2.6 - 1.3).to(dev)[..., 0:2]
    cases += [("ragged", torch.randn((2, 11, 17, 40), generator=g).to(dev), ragged),
              ("odd_channels", torch.randn((2, 11, 17, 13), generator=g).to(dev), ragged),
              ("outside", torch.randn((2, 11, 17, 40), generator=g).to(dev),
               outside_coords(dev))]
    cases += [("edges", torch.randn(shape, generator=g).to(dev), edge_coords(dev, shape[1:3]))
              for shape in ((1, 5, 7, 8), (1, 1, 1, 8), (1, 65, 242, 64))]
    rows = []
    for name, feats, coords in cases:
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            rows.append(sampler_case(name, feats, coords, dtype, tol,
                                     timed=name in FLAGSHIP_SHAPES or name == "ragged"))
            if name == "outside" and bool(library.quad_sample_fwd(
                    feats.to(dtype), coords)[0].any()):
                raise AssertionError(f"outside {dtype}: nonzero output")
        if name == "ragged":
            for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
                rows.append(sampler_case("unaligned", unaligned(feats.to(dtype)), coords,
                                         dtype, tol, timed=False))
    return rows


def contention(idx, w4, padded):
    """Tap adds with a nonzero weight, the pixels that receive any, and the
    most adds one pixel receives."""
    b, hp2, wp2, _ = padded
    taps = torch.cat([idx.long() + o for o in (0, 1, wp2, wp2 + 1)])
    adds = torch.bincount(taps[w4.t().reshape(-1) != 0], minlength=b * hp2 * wp2)
    return {"tap_adds": int(adds.sum()), "pixels_receiving": int((adds > 0).sum()),
            "max_adds_per_pixel": int(adds.max())}


def bwd_case(name, shape, coords, dtype, gen, timed: bool, exact: bool = False):
    """``quad_sample_bwd`` vs its plain version on one input.

    Both sum in f32 (in another order) and round once. f32: atol 1e-5 x
    (1 + max|ref|). bf16: 1e-6 + 2^-7 |ref| (one bf16 rounding) + n u S per
    element, where S is the pixel's sum of |w g| over its n contributions
    (the order bound of an f32 sum, u = 2^-24). ``exact``: small-integer
    cotangents and weights of 1/4, whose sums are exact in f32 whatever the
    order (weights that are multiples of 1/16 keep them exact too): compared
    bit for bit. Every case times the bins and the kernel; ``timed`` also
    compares two calls bit for bit (the kernel uses no atomics) and times
    both together (``ms``, what a training step pays), the plain version and
    the library call, beside the bound and the contention statistics.
    """
    dev = coords.device
    b, h, w, c = shape
    idx, w4 = quad_sample.quad_indices(torch.empty(shape, dtype=dtype, device=dev), coords)
    n = idx.numel()
    padded = (b, h + 2, w + 2, c)
    if exact:
        g = torch.randint(-4, 5, (n, c), generator=gen).to(dtype).to(dev)
    else:
        g = torch.randn((n, c), generator=gen).to(dtype).to(dev)
    bins = quad_sample.quad_bins(idx, w4, padded)
    got = library.quad_sample_bwd(g, idx, w4, padded, bins)
    torch.cuda.synchronize()
    ref = quad_sample_bwd_plain(g, idx, w4, padded)
    diff = (got.float() - ref.float()).abs()
    stats = contention(idx, w4, padded)
    if exact:
        tol = torch.zeros_like(diff)
    elif dtype == torch.float32:
        tol = torch.full_like(diff, F32_TOL * (1 + float(ref.abs().max())))
    else:
        s_abs = quad_sample_bwd_plain(g.float().abs(), idx, w4.abs(), padded)
        tol = 1e-6 + 2.0 ** -7 * ref.float().abs() + stats["max_adds_per_pixel"] * F32_U * s_abs
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
           "queries": n, "max_abs_err": float(diff.max()),
           "max_err_over_tol": float((diff / tol.clamp(min=1e-30)).max()) if not exact else 0.0,
           "bin_ms": cuda_ms(lambda: quad_sample.quad_bins(idx, w4, padded)),
           "kernel_ms": cuda_ms(lambda: library.quad_sample_bwd(g, idx, w4, padded, bins))}
    if timed:
        again = library.quad_sample_bwd(g, idx, w4, padded,
                                            quad_sample.quad_bins(idx, w4, padded))
        row["bit_equal_rerun"] = bool(torch.equal(got, again))
        if not row["bit_equal_rerun"]:
            raise AssertionError(f"{name} {row['dtype']}: two calls differ")
        row.update(stats)
        isz = g.element_size()
        valid = int(bins[1][-1])  # queries with a nonzero weight
        # idx and w4 of every query, the cotangent rows with a nonzero
        # weight, the output once
        nbytes = n * (4 + 16) + valid * c * isz + b * h * w * c * isz
        ops = 2.0 * stats["tap_adds"] * c  # an f32 multiply-add per nonzero tap and channel
        row["valid_queries"] = valid
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S \
            else "operations"
        row["bytes"] = nbytes
        row["ms"] = cuda_ms(lambda: library.quad_sample_bwd(
            g, idx, w4, padded, quad_sample.quad_bins(idx, w4, padded)))
        row["plain_ms"] = cuda_ms(lambda: quad_sample_bwd_plain(g, idx, w4, padded),
                                  iters=3, warmup=1)
        # the same input gradient from one PyTorch call, on the NCHW map
        fmap = torch.zeros((b, c, h, w), dtype=dtype, device=dev)
        grid = coords.reshape(b, -1, coords.shape[-2], 2).to(dtype)
        gout = g.reshape(b, grid.shape[1], grid.shape[2], c).permute(0, 3, 1, 2).contiguous()
        row["library_ms"] = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, fmap, grid, 0, 0, True, [True, False]))
    print("  " + json.dumps(row))
    if not bool((diff <= tol).all()):
        raise AssertionError(f"{name} {row['dtype']}: max error {row['max_abs_err']} "
                             f"over its tolerance")
    return row


# hot tile: a map of B's size with H - 1 and W - 1 powers of 2, so that
# quarter-pixel coords normalize exactly and every weight is a multiple of 1/16
HOT_SHAPE = (1, 65, 257, 192)


def hot_coords(dev, gen, n: int = 1 << 20):
    """(1, n, 2) coords on the quarter-pixel grid of HOT_SHAPE: 90% within
    a quarter pixel of three points, the rest spread over the map and beyond
    it."""
    _, h, w, _ = HOT_SHAPE
    lo, hi = torch.tensor([-2.0, -2.0]), torch.tensor([w + 1.0, h + 1.0])
    px = lo + torch.floor(torch.rand((n, 2), generator=gen) * (hi - lo) * 4) / 4
    points = torch.tensor([[120.5, 30.25], [121.0, 31.0], [7.75, 60.5]])
    k = n * 9 // 10
    px[:k] = (points[torch.randint(0, 3, (k,), generator=gen)]
              + torch.randint(-1, 2, (k, 2), generator=gen) / 4)
    return (px / torch.tensor([w - 1.0, h - 1.0]) * 2 - 1).reshape(1, n, 2).to(dev)


def phase_kernel_vs_plain_bwd(dev):
    uv = flagship_uv(dev)
    gen = torch.Generator(device="cpu").manual_seed(2)
    rows = []
    for name, shape in FLAGSHIP_SHAPES.items():
        rows.append(bwd_case(name, shape, uv, torch.bfloat16, gen, timed=True))
        rows.append(bwd_case(name, shape, uv, torch.float32, gen, timed=False))
    coords = (torch.rand((2, 37, 3, 2), generator=gen) * 2.6 - 1.3).to(dev)
    # contention: 65,536 queries at the center of one 2x2 patch of a 9x9
    # map (normalized -0.375 is pixel 2.5 exactly), all weights 1/4; hot
    # tile: most queries on a few pixels, weights multiples of 1/16; both
    # exact in f32 whatever the order
    centre = torch.full((1, 256, 256, 2), -0.375, device=dev)
    hot = hot_coords(dev, gen)
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(bwd_case("ragged", (2, 11, 17, 40), coords, dtype, gen, timed=False))
        rows.append(bwd_case("contention", (1, 9, 9, 64), centre, dtype, gen, timed=False,
                             exact=True))
        rows.append(bwd_case("hot_tile", HOT_SHAPE, hot, dtype, gen, timed=False, exact=True))
    return rows


def reduce_groups(maps):
    """The fused kernel's (map, k_off) of each map, as
    ``FrustumToVoxelMultiScale.accumulate`` builds them."""
    groups, off = [], 0
    for f in maps:
        groups.append((f, off))
        off += f.shape[-1]
    return groups


def sampling_route(uv, groups, kmat, bias):
    """The same function by the route a training step takes: ``quad_sample_fwd``
    per group (uv read in place, the unpadded map), ``matmul_f32``, ``add_``
    onto the bias; f32, unrounded."""
    out = bias.expand(uv.numel() // 2, kmat.shape[1]).clone()
    for f, k_off in groups:
        out.add_(matmul_f32(library.quad_sample_fwd(f, uv)[0],
                            kmat[k_off:k_off + f.shape[-1]]))
    return out


def library_pair(maps, coords, kmat, bias):
    """The same function from library calls, ``F.grid_sample`` and
    ``torch.matmul`` per group, then the cast (no single PyTorch call
    computes it)."""
    b = coords.shape[0]
    grid = coords.reshape(b, -1, coords.shape[-2], 2).to(kmat.dtype)
    out, k_off = bias, 0
    for f in maps:
        c = f.shape[-1]
        s = F.grid_sample(f.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        out = out + torch.matmul(s.flatten(2).transpose(1, 2),
                                 kmat[k_off:k_off + c]).reshape(-1, kmat.shape[1])
        k_off += c
    return out.to(kmat.dtype)


def reduce_case(name, maps, uv, o, dtype, gen, timed: bool):
    """``quad_sample_reduce_fwd`` vs its plain version on one input, both
    in ``dtype``; ``uv`` is read in place.

    Both sum the products in f32 in another order: f32 within REDUCE_RTOL x
    (1 + max|ref|), the order bound of a sum of sum(c) + 1 terms with room.
    bf16: the plain version combines the taps in bf16 (a rounding after each
    of 4 products and 3 sums, ``quad_sample_fwd_plain``), the kernel in f32
    with one rounding, so it also allows 8 roundings of 2^-8 of the taps'
    magnitude S = sum |w t| through |K|: 2^-5 (S @ |K|); and both round their
    f32 sums once to bf16, which may put them one unit in the last place
    apart: 2^-7 |ref|. The sampling route with the kernel's own rounding of
    the taps (``quad_sample_fwd`` + ``matmul_f32``), cast to bf16, is held
    at REDUCE_RTOL x (1 + max|ref|) + 2^-7 |ref|. ``timed``: the kernel,
    that route, the plain version and the library pair, beside the bound."""
    dev = uv.device
    maps = [m.to(dtype) for m in maps]
    groups = reduce_groups(maps)
    csum = sum(m.shape[-1] for m in maps)
    kmat = (torch.randn((csum, o), generator=gen) * csum ** -0.5).to(dtype).to(dev)
    bias = torch.randn(o, generator=gen).to(dev)
    n = uv.numel() // 2
    got = library.quad_sample_reduce_fwd(uv, groups, kmat, bias)
    torch.cuda.synchronize()
    ref = quad_sample.quad_sample_reduce_plain(uv, groups, kmat, bias)
    rtol = REDUCE_RTOL[dtype]
    tol = rtol * (1 + float(ref.float().abs().max()))
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "maps": [list(m.shape) for m in maps], "o": o, "queries": n,
           "out_dtype": str(got.dtype).replace("torch.", "")}
    if got.dtype != dtype or got.shape != (n, o):
        raise AssertionError(f"{name}: output {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        ratio = float(diff.max()) / tol
    else:
        mag = torch.zeros_like(diff)
        for f, k_off in groups:
            idx, w4 = quad_sample.quad_indices(f, uv)
            fp = F.pad(f, (0, 0, 1, 1, 1, 1)).contiguous()
            s_abs = quad_sample_fwd_plain(fp.float().abs(), idx, w4.abs())
            mag.add_(s_abs @ kmat[k_off:k_off + f.shape[-1]].float().abs())
            del s_abs, fp
        ulp = 2.0 ** -7 * ref.float().abs()
        ratio = float((diff / (tol + 2.0 ** -5 * mag + ulp)).max())
        del mag, ulp
        route = sampling_route(uv, groups, kmat, bias)
        same = (got.float() - route.to(dtype).float()).abs()
        row["max_abs_err_same_rounding"] = float(same.max())
        row["same_rounding_over_tol"] = float((same / (tol + 2.0 ** -7 * route.abs())).max())
        del route, same
    row.update(max_abs_err=float(diff.max()), max_err_over_tol=ratio,
               finite=bool(torch.isfinite(got).all()))
    del diff, ref
    if timed:
        isz = kmat.element_size()
        # uv (x, y) read once, each map and K once, the output written once
        nbytes = (n * 8 + sum(m.numel() * isz for m in maps) + kmat.numel() * isz + o * 4
                  + n * o * isz)
        ops = 2.0 * n * csum * o
        peak = F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
        row["bytes"], row["ops"] = nbytes, ops
        # computed, not measured: the four tap rows of every query and group
        # that pass through L2, beside the bound
        row["computed_l2_tap_bytes"] = 4 * csum * isz * n
        row["ms"] = cuda_ms(lambda: library.quad_sample_reduce_fwd(uv, groups, kmat, bias))
        row["sampling_route_ms"] = cuda_ms(lambda: sampling_route(uv, groups, kmat, bias))
        row["plain_ms"] = cuda_ms(lambda: quad_sample.quad_sample_reduce_plain(
            uv, groups, kmat, bias), iters=3, warmup=1)
        # no single PyTorch call computes this function: library_ms stays null,
        # the pair of calls that does is timed beside it
        row["library_ms"] = None
        row["library_pair"] = "F.grid_sample + torch.matmul per group, cast"
        row["library_pair_ms"] = cuda_ms(lambda: library_pair(maps, uv, kmat, bias))
    print("  " + json.dumps(row))
    if not row["finite"] or not ratio <= 1.0 or not row.get("same_rounding_over_tol", 0) <= 1.0:
        raise AssertionError(f"{name} {row['dtype']}: max error {row['max_abs_err']} over its "
                             f"tolerance")
    return row


def edge_coords(dev, sizes, n: int = 4096, seed: int = 11):
    """(1, M, 2) coordinates on and around every edge of maps of ``sizes``
    pixels: exactly -1 and 1, one f32 step either side, one and half a
    pixel in and out, far beyond, crossed in x and y; then ``n`` random
    ones."""
    one = torch.tensor(1.0)
    special = [torch.tensor([-1.0, 1.0, 0.0, -1.5, 1.5, -3.0, 3.0, 1e6, -1e6])]
    special += [torch.nextafter(v, 2 * v)[None] for v in (-one, one)]
    special += [torch.nextafter(v, -2 * v)[None] for v in (-one, one)]
    for size in sizes:
        step = 2.0 / max(size - 1, 1)
        special.append(torch.tensor([-1 + step, 1 - step, -1 - step, 1 + step,
                                     -1 + step / 2, 1 - step / 2]))
    special = torch.cat(special)
    xs, ys = torch.meshgrid(special, special, indexing="ij")
    g = torch.Generator().manual_seed(seed)
    rand = torch.rand((n, 2), generator=g) * 2.6 - 1.3
    return torch.cat([torch.stack([xs.reshape(-1), ys.reshape(-1)], -1), rand])[None].to(dev)


def phase_taps(dev):
    """The fused kernel's own tap computation (``quad_sample_taps``)
    against ``quad_indices`` bit for bit, in bf16 and f32: at the flagship
    grid read in place (both maps), at ragged coordinates (two frames,
    beyond the maps), and at coordinates on, beside and just beyond every
    edge."""
    grid = flagship_grid(dev)
    g = torch.Generator().manual_seed(12)
    ragged = (torch.rand((2, 37, 3, 3), generator=g) * 2.6 - 1.3).to(dev)[..., 0:2]
    cases = [("flagship", shape, grid[..., 0:2]) for shape in FLAGSHIP_SHAPES.values()]
    cases += [("ragged", (2, 11, 17, 8), ragged), ("ragged", (2, 3, 4, 8), ragged)]
    cases += [("edges", shape, edge_coords(dev, shape[1:3])) for shape in
              ((1, 5, 7, 8), (1, 1, 1, 8), FLAGSHIP_SHAPES["B"])]
    rows = []
    for name, shape, uv in cases:
        for dtype in (torch.bfloat16, torch.float32):
            f = torch.empty((shape[0], shape[1], shape[2], 1), dtype=dtype, device=dev)
            idx, w4 = library.quad_sample_taps(f, uv)
            torch.cuda.synchronize()
            ref_idx, ref_w4 = quad_sample.quad_indices(f, uv)
            row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
                   "map": list(shape[:3]), "queries": int(idx.numel()),
                   "idx_equal": bool(torch.equal(idx, ref_idx)),
                   "w4_equal": bool(torch.equal(w4, ref_w4)),
                   "w4_max_abs_diff": float((w4 - ref_w4).abs().max()),
                   "taps_outside": int((w4 == 0).sum())}
            print("  " + json.dumps(row))
            rows.append(row)
            if not (row["idx_equal"] and row["w4_equal"]):
                raise AssertionError(f"taps {name} {row['dtype']} {shape}: not bit-equal")
    return rows


def scatter_inputs(p: int, c: int, n: int, gen, integer: bool, window: int = 2048):
    """P5's inputs on the card: ``n`` update indices, each tile of ``window``
    within a window of ``window`` table rows (``_bench_scatter_pallas.py::
    make_inputs``' generator, drawn here by the card's generator), and bf16
    rows, random or small integers."""
    dev = gen.device
    win = min(window, p)
    tiles = -(-n // window)
    base = torch.randint(0, p - win + 1, (tiles, 1), generator=gen, device=dev)
    idx = (base + torch.randint(0, win, (tiles, window), generator=gen, device=dev))
    idx = idx.reshape(-1)[:n].to(torch.int32)
    if integer:
        rows = torch.randint(-2, 3, (n, c), generator=gen, device=dev).to(torch.bfloat16)
    else:
        rows = torch.randn((n, c), generator=gen, device=dev, dtype=torch.bfloat16)
    return idx, rows


def scatter_case(name, idx, rows, p: int, timed: bool, exact: bool):
    """``row_scatter_add`` vs ``row_scatter_add_plain`` on one input.

    ``exact``: integer-valued rows, whose f32 sums are exact in any order,
    compared bit for bit. Otherwise both sum in f32 in another order and
    round once to the rows' dtype, so a result may sit one rounding apart:
    |kernel - plain| <= 1e-6 + 2 u |plain| (one unit in the last place of
    the dtype, whose unit round-off is u: 2^-7 |plain| in bf16) + k u_f32 S
    (the f32 order bound: k the most updates one row receives, S the row's
    sum of |rows|). Every case checks two calls
    bit for bit; ``timed`` also times the kernel with its binning (``ms``),
    the binning and the kernel alone, the plain version and ``index_add_``
    into a zeroed bf16 table, beside the bound."""
    dev = rows.device
    got = row_scatter.row_scatter_add(idx, rows, p)
    again = row_scatter.row_scatter_add(idx, rows, p)
    torch.cuda.synchronize()
    ref = row_scatter.row_scatter_add_plain(idx, rows, p)
    bins = row_scatter.row_scatter_bins(idx, p)
    counts = bins[1].diff()
    diff = (got.float() - ref.float()).abs()
    if exact:
        tol = torch.zeros_like(diff)
    else:
        s_abs = row_scatter.row_scatter_add_plain(idx, rows.float().abs(), p)
        u = {torch.bfloat16: 2.0 ** -8, torch.float32: F32_U}[rows.dtype]
        tol = 1e-6 + 2 * u * ref.float().abs() + int(counts.max()) * F32_U * s_abs
        del s_abs
    n, c = rows.shape
    row = {"case": name, "dtype": str(rows.dtype).replace("torch.", ""), "table": [p, c],
           "rows": n, "in_table": int(bins[1][-1]), "max_updates_per_row": int(counts.max()),
           "mean_updates_per_row": float(counts.float().mean()), "exact": exact,
           "max_abs_err": float(diff.max()),
           "max_err_over_tol": float((diff / tol.clamp(min=1e-30)).max()) if not exact else 0.0,
           "bit_equal_rerun": bool(torch.equal(got, again))}
    ok = bool((diff <= tol).all()) and row["bit_equal_rerun"]
    del diff, tol, ref, again
    if timed:
        isz = rows.element_size()
        # every update row and index read once, every table row written once
        nbytes = n * c * isz + n * idx.element_size() + p * c * isz
        ops = float(n * c)  # one f32 add per update element
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S \
            else "operations"
        row["bytes"] = nbytes
        row["ms"] = cuda_ms(lambda: row_scatter.row_scatter_add(idx, rows, p))
        row["binning_ms"] = cuda_ms(lambda: row_scatter.row_scatter_bins(idx, p))
        row["kernel_only_ms"] = cuda_ms(lambda: row_scatter.row_scatter_add_kernel(rows, bins, p))
        row["plain_ms"] = cuda_ms(lambda: row_scatter.row_scatter_add_plain(idx, rows, p),
                                  iters=3, warmup=1)
        row["library"] = "index_add_ into a zeroed bf16 table"
        row["library_ms"] = cuda_ms(lambda: torch.zeros((p, c), dtype=rows.dtype,
                                                        device=dev).index_add_(0, idx, rows))
    print("  " + json.dumps(row))
    if not ok:
        raise AssertionError(f"{name}: max error {row['max_abs_err']} over its tolerance or "
                             f"two calls differ")
    return row


def phase_kernel_vs_plain_scatter(dev):
    """``row_scatter_add`` against its plain version at P5's four cases
    (3,174,400 rows into each table of ``_bench_scatter_pallas.py``'s
    CASES), random bf16 rows (timed) and integer-valued ones; then a ragged
    case: odd channels, negative and out-of-range indices, and one row
    receiving every update."""
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for name, p, cq in bench_scatter.CASES:
        for integer in (False, True):
            idx, upd = scatter_inputs(p, cq, FLAGSHIP_QUERIES, gen, integer)
            rows.append(scatter_case(name, idx, upd, p, timed=not integer, exact=integer))
            del idx, upd
            torch.cuda.empty_cache()
    p, n = 301, 40_000
    idx = torch.randint(-p - 50, p + 50, (n,), generator=gen, device=dev).to(torch.int32)
    idx[: n // 2] = 7  # one row receives half the updates, and another all of them below
    for integer in (False, True):
        upd = (torch.randint(-2, 3, (n, 37), generator=gen, device=dev).to(torch.bfloat16)
               if integer else torch.randn((n, 37), generator=gen, device=dev,
                                           dtype=torch.bfloat16))
        rows.append(scatter_case("ragged", idx, upd, p, timed=False, exact=integer))
        rows.append(scatter_case("one_row", torch.full_like(idx, -3), upd.float(), p,
                                 timed=False, exact=integer))
    return rows


# the case of P5's entry point that chip_smoke runs (numpy draws its inputs:
# about 25 s for each of the four at N = 3,174,400); kernel_vs_plain_scatter
# holds the kernel at all four
BENCH_SCATTER_CASES = ("g4",)


def phase_bench_scatter(dev):
    """P5's entry point, ``python -m hgsfusion_tpu_torch.bench_scatter``, on
    BENCH_SCATTER_CASES at 3 timed calls each: the kernel launched."""
    zero_launches()
    results = bench_scatter.main(["--cases", *BENCH_SCATTER_CASES, "--iters", "3",
                                  "--device", str(dev)])
    launches = dict(row_scatter.launches)
    # per case: the kernel, the kernel alone on prebuilt bins and the
    # outer-product route, each a warm-up and 3 calls
    want = {row_scatter.KERNEL: 3 * 4 * len(BENCH_SCATTER_CASES)}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    return {"launches": launches, "cases": results}


# -- rotated NMS ---------------------------------------------------------------
# the configs' candidates (NMS_PRE_MAXSIZE) and kept boxes (NMS_POST_MAXSIZE)
NMS_K, NMS_KEEP, NMS_THRESH = 4096, 500, 0.01
# candidates beyond what one block's shared memory held (the single-launch
# kernel refused them): the op takes any K whose mask fits int32 indexing
NMS_K_BIG = 8192
# one NMS op: the mask, then the sweep
NMS_CALL = {library.NMS_MASK: 1, library.NMS_SWEEP: 1}
# a keep decision of the kernels (or a bit of the mask) may differ from the
# plain rule only where an IoU lies within this of the threshold (the small
# sums' order, see csrc/nms_lazy.cu)
NMS_TIE = 1e-5
# f32 operations of one IoU in csrc/nms_lazy.cu, counted from its source
# (a division as one operation): the centroid 20, the shift 16, each of the
# two half boundaries 16 edge pairs of 16 operations and a division, and 4
# edges of 13, plus the union and the quotient; and of the circumcircle
# test that precedes it (and decides alone for a box clear of the kept one)
NMS_OPS_PER_IOU, NMS_OPS_PER_TEST = 700, 12
NMS_DISC_MARGIN = 1e-3  # csrc/nms_lazy.cu DISC_MARGIN


def clustered_boxes(k: int, clusters: int, seed: int):
    """(k, 7) f32 boxes of VoD's classes around ``clusters`` centres in the
    VoD range, 0.3 m of jitter, random headings, in random order (the order
    is the score order): about 584 survive NMS at 0.01 for 800 clusters."""
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(0.0, 51.2, clusters), rng.uniform(-25.6, 25.6, clusters)
    member = rng.randint(0, clusters, k)
    sizes = np.array([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]], np.float32)
    cls = rng.randint(0, 3, clusters)[member]
    boxes = np.zeros((k, 7), np.float32)
    boxes[:, 0] = cx[member] + rng.normal(0, 0.3, k)
    boxes[:, 1] = cy[member] + rng.normal(0, 0.3, k)
    boxes[:, 2] = rng.uniform(-2, 0, k)
    boxes[:, 3:6] = sizes[cls] * rng.uniform(0.9, 1.1, (k, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, k)
    return boxes


def degenerate_boxes(k: int, seed: int):
    """Exact duplicates, boxes that share an edge, one box inside another
    and zero-area boxes, in random order."""
    rng = np.random.RandomState(seed)
    base = clustered_boxes(k // 8, k // 16, seed)
    touching = base.copy()
    touching[:, 0] += base[:, 3] * np.cos(base[:, 6])  # moved one length along the heading
    touching[:, 1] += base[:, 3] * np.sin(base[:, 6])
    inside = base.copy()
    inside[:, 3:5] *= 0.5
    flat = base.copy()
    flat[:, 4] = 0.0
    boxes = np.concatenate([base, base, base, touching, inside, flat, base, touching])[:k]
    return boxes[rng.permutation(k)]


def plain_nms_batch(boxes, valid, nms_thresh: float, max_keep: int):
    """The plain version, frame by frame (``greedy_nms_lazy_plain``, one host
    read a frame)."""
    return torch.stack([nms.greedy_nms_lazy_plain(b, v, nms_thresh, max_keep)
                        for b, v in zip(boxes, valid)])


def check_nms_frame(boxes, valid, keep, nms_thresh: float, max_keep: int) -> dict:
    """Every keep decision of ``keep`` against the greedy rule given its own
    earlier decisions, with the plain IoU (``boxes_iou_bev``): a valid
    candidate is kept iff fewer than ``max_keep`` were kept before it and
    no kept one before it overlaps it by more than ``nms_thresh``. A
    decision that breaks the rule counts as a tie where an earlier kept
    box's IoU with it lies within NMS_TIE of the threshold; any other
    raises. Returns the kept count, the tie decisions, and the circle tests
    and IoU evaluations the kernel's sweep makes (for its bound)."""
    kept = torch.nonzero(keep).squeeze(1)
    if bool((keep & ~valid).any()) or kept.numel() > max_keep:
        raise AssertionError(f"kept {kept.numel()} (max {max_keep}), some invalid")
    n = keep.shape[0]
    cols = torch.arange(n, device=keep.device)
    if kept.numel():
        iou = torch.cat([boxes_iou_bev(boxes[kept[r:r + 64]], boxes)
                         for r in range(0, kept.numel(), 64)])
    else:
        iou = torch.zeros((0, n), device=keep.device)
    before = kept[:, None] < cols[None, :]
    over = (iou > nms_thresh) & before
    suppressed = over.any(0)
    tie = (((iou - nms_thresh).abs() <= NMS_TIE) & before).any(0)
    count_before = torch.searchsorted(kept, cols)  # kept candidates before each
    decided = valid & (count_before < max_keep)
    rule = decided & ~suppressed
    wrong = keep != rule
    if bool((wrong & ~tie).any()):
        j = int(torch.nonzero(wrong & ~tie)[0])
        raise AssertionError(f"candidate {j}: kept {bool(keep[j])}, the rule says {bool(rule[j])}")
    # the sweep tests candidate j at every kept step i < j up to and
    # including its first suppressor, while it is live and valid, and
    # evaluates the IoU where the two circumcircles are not clear
    first = torch.where(over, kept[:, None], torch.full_like(over, n, dtype=torch.long))
    first = first.amin(0) if kept.numel() else torch.full_like(cols, n)
    tested = (kept[:, None] <= first[None, :]) & before & valid[None, :]
    r = 0.5 * torch.sqrt(boxes[:, 3] ** 2 + boxes[:, 4] ** 2)
    gap = r[kept][:, None] + r[None, :]
    gap = gap + NMS_DISC_MARGIN * (1 + gap)
    dist2 = ((boxes[kept, None, :2] - boxes[None, :, :2]) ** 2).sum(-1)
    return {"kept": kept.numel(), "tie_decisions": int(wrong.sum()),
            "circle_tests": int(tested.sum()),
            "iou_evals": int((tested & (dist2 <= gap * gap)).sum())}


def near_pairs(boxes, valid) -> int:
    """Valid pairs i < j whose circumcircles are not clear of each other by
    csrc/nms_lazy.cu's test: the IoUs ``nms_mask`` evaluates."""
    k = valid.shape[0]
    r = 0.5 * torch.sqrt(boxes[:, 3] ** 2 + boxes[:, 4] ** 2)
    rows = torch.nonzero(valid).squeeze(1)
    cols = torch.arange(k, device=boxes.device)
    total = 0
    for r0 in range(0, rows.numel(), 512):
        i = rows[r0:r0 + 512]
        gap = r[i][:, None] + r[None, :]
        gap = gap + NMS_DISC_MARGIN * (1 + gap)
        dist2 = ((boxes[i, None, :2] - boxes[None, :, :2]) ** 2).sum(-1)
        total += int(((dist2 <= gap * gap) & valid[None, :] & (cols[None, :] > i[:, None])).sum())
    return total


def mask_words_written(valid) -> int:
    """The words ``nms_mask`` writes for one frame: each row tile holding a
    valid candidate, its rows times the tiles from its own on."""
    k = valid.shape[0]
    tiles = -(-k // 64)
    t = torch.arange(tiles, device=valid.device)
    has_valid = F.pad(valid, (0, tiles * 64 - k)).view(tiles, 64).any(1)
    rows = torch.clamp(k - 64 * t, max=64)
    return int((has_valid * rows * (tiles - t)).sum())


def check_nms_mask(boxes, valid, mask, nms_thresh: float) -> dict:
    """``nms_mask``'s words of one frame against ``nms_mask_plain``'s where
    the sweep reads them (rows of valid candidates, from their own tile on):
    a bit may differ only at an IoU within NMS_TIE of the threshold (any
    other raises). Returns the differing bits and the pairs the kernel
    tests (every valid i < j) and evaluates (their circumcircles not
    clear)."""
    k = valid.shape[0]
    want = nms.nms_mask_plain(boxes, valid, nms_thresh)
    tiles = want.shape[1]
    idx = torch.arange(k, device=boxes.device)
    read = valid[:, None] & (torch.arange(tiles, device=boxes.device)[None] >= (idx // 64)[:, None])
    diff = torch.where(read, mask ^ want, torch.zeros_like(want))
    rows, words = torch.nonzero(diff, as_tuple=True)
    pairs = []
    for i, w in zip(rows.tolist(), words.tolist()):
        bits = int(diff[i, w]) & (2**64 - 1)
        pairs += [(i, 64 * w + b) for b in range(64) if bits >> b & 1]
    for i, j in pairs:
        iou = float(boxes_iou_bev(boxes[i:i + 1], boxes[j:j + 1])[0, 0])
        if abs(iou - nms_thresh) > NMS_TIE:
            raise AssertionError(f"mask bit ({i}, {j}): IoU {iou} at threshold {nms_thresh}")
    nv = int(valid.sum())
    return {"tie_bits": len(pairs), "circle_tests": nv * (nv - 1) // 2,
            "iou_evals": near_pairs(boxes, valid)}


def nms_case(name, boxes, valid, max_keep: int, timed: bool,
             nms_thresh: float = NMS_THRESH) -> dict:
    """``nms_lazy`` (the op: ``nms_mask``, then ``nms_sweep``) against the
    plain version on (B, K) candidates: each frame's decisions checked by
    ``check_nms_frame``, the keep sets compared with the plain version's;
    the mask held to ``nms_mask_plain`` by ``check_nms_mask``, the sweep to
    ``nms_sweep_plain`` over the kernel's own mask bit for bit. Timed: the
    op and each kernel (graph replays), the plain versions, and
    ``class_agnostic_nms`` on scores that order the boxes as given, with the
    op and with the plain version (the route before the kernels), beside
    the bounds."""
    got = nms.nms_lazy_op(boxes, valid, nms_thresh, max_keep)
    want = plain_nms_batch(boxes, valid, nms_thresh, max_keep)
    frames = [check_nms_frame(b, v, g, nms_thresh, max_keep)
              for b, v, g in zip(boxes, valid, got)]
    mask = library.nms_mask(boxes, valid, nms_thresh)
    masks = [check_nms_mask(b, v, m, nms_thresh) for b, v, m in zip(boxes, valid, mask)]
    sweep = library.nms_sweep(mask, valid, max_keep)
    row = {"case": name, "shape": list(boxes.shape), "nms_thresh": nms_thresh,
           "valid": int(valid.sum()),
           "max_keep": max_keep, "kept": [f["kept"] for f in frames],
           "tie_decisions": sum(f["tie_decisions"] for f in frames),
           "equal_to_plain": bool(torch.equal(got, want)),
           "differs_from_plain": int((got != want).sum()),
           "circle_tests": sum(f["circle_tests"] for f in frames),
           "iou_evals": sum(f["iou_evals"] for f in frames),
           "mask_tie_bits": sum(m["tie_bits"] for m in masks),
           "mask_circle_tests": sum(m["circle_tests"] for m in masks),
           "mask_iou_evals": sum(m["iou_evals"] for m in masks),
           "sweep_equal_to_op": bool(torch.equal(sweep, got)),
           "sweep_equal_to_plain_sweep": all(
               torch.equal(nms.nms_sweep_plain(m, v, max_keep), s)
               for m, v, s in zip(mask, valid, sweep))}
    if not (row["sweep_equal_to_op"] and row["sweep_equal_to_plain_sweep"]):
        raise AssertionError(f"{name}: the sweep differs from the op or its plain version")
    if timed:
        k = boxes.shape[1]
        scores = torch.linspace(1.0, 0.5, k, device=boxes.device).expand(boxes.shape[0], k)
        scores = torch.where(valid, scores, torch.zeros_like(scores))

        def route():
            return nms.class_agnostic_nms(scores, boxes, 0.1, nms_thresh, k, max_keep)

        row["ms"] = graph_ms(lambda: nms.nms_lazy_op(boxes, valid, nms_thresh, max_keep),
                             iters=3, replays=2)
        row["mask_ms"] = graph_ms(lambda: library.nms_mask(boxes, valid, nms_thresh),
                                  iters=3, replays=2)
        row["sweep_ms"] = graph_ms(lambda: library.nms_sweep(mask, valid, max_keep),
                                   iters=3, replays=2)
        row["plain_ms"] = cuda_ms(lambda: plain_nms_batch(boxes, valid, nms_thresh, max_keep),
                                  iters=2, warmup=1)
        row["mask_plain_ms"] = cuda_ms(lambda: [nms.nms_mask_plain(b, v, nms_thresh)
                                                for b, v in zip(boxes, valid)], iters=2, warmup=1)
        row["sweep_plain_ms"] = cuda_ms(lambda: [nms.nms_sweep_plain(m, v, max_keep)
                                                 for m, v in zip(mask, valid)], iters=1, warmup=1)
        row["route_ms"] = cuda_ms(route, iters=5, warmup=1)
        with mock.patch.object(nms, "nms_lazy_op", plain_nms_batch):
            row["plain_route_ms"] = cuda_ms(route, iters=2, warmup=1)
        # the op: the circle tests and IoU evaluations the greedy rule needs
        # on this input, over the f32 peak (boxes, valid and the keep mask
        # move a few hundred KB)
        row["bound_ms"] = (row["iou_evals"] * NMS_OPS_PER_IOU + row["circle_tests"]
                           * NMS_OPS_PER_TEST) / F32_FLOPS_PER_S * 1e3
        row["bytes_bound_ms"] = boxes.numel() * 6 / HBM_BYTES_PER_S * 1e3
        row["bound_by"] = "operations"
        # nms_mask's own work: every valid pair's circle test and the near
        # pairs' IoUs, or its words written, the larger
        mask_s = (row["mask_iou_evals"] * NMS_OPS_PER_IOU
                  + row["mask_circle_tests"] * NMS_OPS_PER_TEST) / F32_FLOPS_PER_S
        words = sum(mask_words_written(v) for v in valid)
        row["mask_bound_ms"] = max(mask_s, 8 * words / HBM_BYTES_PER_S) * 1e3
        row["mask_bound_by"] = "operations" if mask_s >= 8 * words / HBM_BYTES_PER_S \
            else "bytes"
        # nms_sweep's bytes: the valid flags read, the keep mask written, the
        # kept rows' words from their own tile on read
        tiles = mask.shape[-1]
        kept_words = sum(int((tiles - torch.nonzero(g).squeeze(1) // 64).sum()) for g in got)
        row["sweep_bound_ms"] = (2 * valid.numel() + 8 * kept_words) / HBM_BYTES_PER_S * 1e3
        row["library_ms"] = None  # no PyTorch call computes rotated NMS
    row["max_abs_err"] = float(row["differs_from_plain"] > 0)  # the keep masks, 0 or 1
    print("  " + json.dumps(row))
    return row


# the multi-head config's NMS (configs/pp_multihead_nuscenes.yaml): up to
# 1,000 candidates a (frame, class) set at IoU 0.2, 83 kept, 10 sets a frame
MH_NMS_K, MH_NMS_KEEP, MH_NMS_THRESH, MH_SETS = 1000, 83, 0.2, 10


def nuscenes_candidate_sets(sets: int, k: int, seed: int):
    """(sets, k, 7) f32 boxes, set s of nuScenes class s % 10 at that
    class's anchor size (x 0.9-1.1), around k / 3 centres in the
    multi-head config's +-51.2 m range with 0.4 m of jitter, random
    headings: overlapping clusters, as a class's top scores are."""
    anchors = model_config_from_yaml(load_config(PP_YAML)).anchor_generator
    rng = np.random.RandomState(seed)
    out = np.zeros((sets, k, 7), np.float32)
    for si in range(sets):
        size = np.asarray(anchors[si % len(anchors)]["anchor_sizes"][0], np.float32)
        centres = rng.uniform(-51.2, 51.2, (k // 3, 2))
        member = rng.randint(0, len(centres), k)
        out[si, :, :2] = centres[member] + rng.normal(0, 0.4, (k, 2))
        out[si, :, 2] = rng.uniform(-2, 1, k)
        out[si, :, 3:6] = size * rng.uniform(0.9, 1.1, (k, 3))
        out[si, :, 6] = rng.uniform(-np.pi, np.pi, k)
    return out


def phase_kernel_vs_plain_nms(dev):
    """``nms_lazy`` against ``greedy_nms_lazy_plain`` at the configs' 4,096
    candidates, 0.01: (a) the worst case, every candidate valid, clustered
    boxes, 500 kept; (b) the trained-model regime, 64 valid; (c) two frames
    in one launch; (d) duplicated, touching, nested and zero-area boxes;
    (e) no valid candidate; (f) a ``max_keep`` cut at 37 and (g) at 64, a
    mask tile's end; (h) 8,192 candidates, every one valid; then the
    multi-head regime (``post_process_multihead``'s stacked sets): (i) one
    frame's 10 per-class sets and (j) B=4's 40, 1,000 candidates each, all
    valid, at 0.2, 83 kept a set."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    worst = t(clustered_boxes(NMS_K, 800, 0))[None]
    all_valid = torch.ones((1, NMS_K), dtype=torch.bool, device=dev)
    prefix = torch.arange(NMS_K, device=dev)[None] < 64
    pair = t(np.stack([clustered_boxes(NMS_K, 800, 1), clustered_boxes(NMS_K, 1600, 2)]))
    rows = [
        nms_case("worst", worst, all_valid, NMS_KEEP, timed=True),
        nms_case("realistic", worst, prefix, NMS_KEEP, timed=True),
        nms_case("batch2", pair, all_valid.expand(2, -1).contiguous(), NMS_KEEP, timed=True),
        nms_case("degenerate", t(degenerate_boxes(NMS_K, 3))[None], all_valid, NMS_KEEP,
                 timed=False),
        nms_case("none_valid", worst, torch.zeros_like(all_valid), NMS_KEEP, timed=False),
        nms_case("max_keep", worst, all_valid, 37, timed=False),
        nms_case("max_keep64", worst, all_valid, 64, timed=False),
        nms_case("k8192", t(clustered_boxes(NMS_K_BIG, 1600, 4))[None],
                 torch.ones((1, NMS_K_BIG), dtype=torch.bool, device=dev), NMS_KEEP, timed=True),
    ]
    for name, sets in (("multihead10", MH_SETS), ("multihead40", 4 * MH_SETS)):
        rows.append(nms_case(name, t(nuscenes_candidate_sets(sets, MH_NMS_K, 5)),
                             torch.ones((sets, MH_NMS_K), dtype=torch.bool, device=dev),
                             MH_NMS_KEEP, timed=True, nms_thresh=MH_NMS_THRESH))
        if not all(0 < n <= MH_NMS_KEEP for n in rows[-1]["kept"]):
            raise AssertionError(f"{name}: kept {rows[-1]['kept']}")
        if not rows[-1]["equal_to_plain"] and not rows[-1]["tie_decisions"]:
            raise AssertionError(f"{name}: keep sets differ from the plain version's")
    kept = [r["kept"] for r in rows]
    if kept[0] != [NMS_KEEP] or kept[4] != [0] or kept[5] != [37] or kept[6] != [64] \
            or kept[7] != [NMS_KEEP]:
        raise AssertionError(f"kept {kept}")
    print(f"  tie decisions: {sum(r['tie_decisions'] for r in rows)}, mask tie bits: "
          f"{sum(r['mask_tie_bits'] for r in rows)}")
    return rows


def phase_kernel_vs_plain_reduce(dev):
    """The fused kernel at the flagship gather groups (both maps, the
    flagship frame's grid read in place as the module reads it, the reduce
    kernel's (256, 128) shape, a random bias) in bf16 (timed) and f32, and a
    ragged case."""
    uv = flagship_grid(dev)[..., 0:2]
    g = torch.Generator(device="cpu").manual_seed(4)
    maps = [torch.randn(shape, generator=g).to(dev) for shape in FLAGSHIP_SHAPES.values()]
    rows = [reduce_case("flagship", maps, uv, REDUCE_O, torch.bfloat16, g, timed=True),
            reduce_case("flagship", maps, uv, REDUCE_O, torch.float32, g, timed=False)]
    del maps
    torch.cuda.empty_cache()
    # odd channels and outputs, three groups of two frames, 222 queries
    maps = [torch.randn(shape, generator=g).to(dev)
            for shape in ((2, 11, 17, 13), (2, 6, 9, 37), (2, 3, 4, 5))]
    coords = (torch.rand((2, 37, 3, 3), generator=g) * 2.6 - 1.3).to(dev)[..., 0:2]
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(reduce_case("ragged", maps, coords, 45, dtype, g, timed=False))
    return {"rows": rows}


def polar_coords(dev):
    """The flagship frame's polar sample coordinates, by map of
    POLAR_SHAPES: the near-field grid (1, 320, 20, 31, 2) for both reduced
    maps, pass 3's clamped coordinates (1, 320, 300, 2) for q."""
    cfg = vod_polar_config()
    batch = flagship_batch(cfg)
    l2c, c2i, bda = (torch.from_numpy(batch[k]).to(dev) for k in
                     ("trans_lidar_to_cam", "trans_cam_to_img", "lidar_aug_matrix"))
    geo = polar_geometry(l2c, c2i, cfg.image_size, bda, grid_size=cfg.grid_size,
                         pc_range=cfg.pc_range, w_fine=POLAR_SHAPES["near_A"][2],
                         zeta_bins=cfg.f2v_polar_zeta_bins,
                         near_columns=cfg.f2v_polar_near_columns, bev_aug=cfg.bev_aug)
    # as the module reads them: near_uv is (u, v) of the near grid in place
    return {"near_A": geo.near_uv, "near_B": geo.near_uv, "q": geo.far_coords}


def phase_kernel_vs_plain_polar(dev):
    """Both kernels against their plain versions at the polar view's maps."""
    coords = polar_coords(dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    rows = {"fwd": [], "bwd": []}
    for name, shape in POLAR_SHAPES.items():
        feats = torch.randn(shape, generator=g).to(dev)
        rows["fwd"].append(sampler_case(name, feats, coords[name], torch.bfloat16, BF16_TOL,
                                        timed=True))
        rows["fwd"].append(sampler_case(name, feats, coords[name], torch.float32, F32_TOL,
                                        timed=True))
        rows["bwd"].append(bwd_case(name, shape, coords[name], torch.bfloat16, g, timed=True))
        rows["bwd"].append(bwd_case(name, shape, coords[name], torch.float32, g, timed=False))
    return rows


def phase_polar_vs_gather(dev):
    """Full width, f32, one set of weights: the polar image BEV's near
    columns against the gather path's; the far field's agreement printed."""
    f32 = dict(compute_dtype="float32")
    gather = HGSFusionModel(dataclasses.replace(vod_pallas_config(), **f32), device=dev, seed=0)
    cfg = dataclasses.replace(vod_polar_config(), **f32)
    polar = HGSFusionModel(cfg, device=dev, seed=0)
    polar.load_state_dict(gather.state_dict(), strict=True)
    with torch.inference_mode():
        b = gather.batch_to_device(flagship_batch(cfg))
        feats, _ = gather.image_features(b)
        ref = gather.view_transform(feats, b).double()
        got = polar.view_transform(feats, b).double()
    n = cfg.f2v_polar_near_columns
    scale = float(ref.abs().max())
    near_err = float((got[:, :, :n] - ref[:, :, :n]).abs().max())
    far_g, far_p = ref[:, :, n:].flatten(), got[:, :, n:].flatten()
    result = {
        "shape": list(got.shape), "max_abs_gather": scale,
        "near_columns": n, "near_max_abs_err": near_err,
        "near_err_over_max": near_err / scale, "near_tol": NEAR_TOL,
        "far_corr": float(torch.corrcoef(torch.stack([far_g, far_p]))[0, 1]),
        "far_rel_l2": float((far_p - far_g).norm() / far_g.norm()),
        "finite": bool(torch.isfinite(got).all()),
    }
    print("  " + json.dumps(result))
    if not result["finite"]:
        raise AssertionError("non-finite polar image BEV")
    if not near_err <= NEAR_TOL * scale:
        raise AssertionError(f"near field off the gather path: {near_err} > {NEAR_TOL} x {scale}")
    return result


def phase_small_reference(dev, cfg=TINY, batch=None):
    """TINY model: card (kernel path) vs CPU (plain sampler), same weights,
    on ``batch`` (default ``tiny_batch()``)."""
    cpu_model = HGSFusionModel(cfg, device="cpu", seed=5)
    gpu_model = HGSFusionModel(cfg, device=dev, seed=5)
    batch = tiny_batch() if batch is None else batch
    with torch.inference_mode():
        ref = cpu_model(cpu_model.batch_to_device(batch))
        got = gpu_model(gpu_model.batch_to_device(batch))
        errs = {k: float((got[k].cpu() - ref[k]).abs().max()) for k in ref}
        print("  head max abs err vs CPU: " + json.dumps(errs))
        for k in ref:
            torch.testing.assert_close(got[k].cpu(), ref[k], rtol=1e-4, atol=1e-4)
        # identical feature regions give exactly equal scores, which topk
        # orders differently on the two devices: break the ties first
        cls = ref["cls_preds"]
        ref = {**ref, "cls_preds": cls + torch.linspace(0, 0.1, cls.numel()).view(cls.shape)}
        kw = dict(score_thresh=0.0, nms_thresh=0.01, pre_max_size=512, post_max_size=100)
        d_ref = post_process(ref, cpu_model.anchors, cpu_model.box_coder, cfg, **kw)
        d_got = post_process({k: v.to(dev) for k, v in ref.items()}, gpu_model.anchors,
                             gpu_model.box_coder, cfg, **kw)
        assert torch.equal(d_got["valid"].cpu(), d_ref["valid"])
        v = d_ref["valid"]
        torch.testing.assert_close(d_got["boxes"].cpu()[v], d_ref["boxes"][v],
                                   rtol=1e-5, atol=1e-5)
        print(f"  post-process: {int(v.sum())} boxes kept on both")
    return errs


def run_train_step(cfg, device, batch, seed: int, perturb_seed=None):
    """One training step of a model built from ``seed`` (its backbone's
    residual scales at 0) on ``device``: ``step_compare.step_record`` and
    the step's learning rate. With ``perturb_seed``, the images and points
    are first perturbed by ``step_compare.PERTURB`` relative."""
    model = zero_residual_scales(HGSFusionModel(cfg, device=device, seed=seed))
    assigner = TargetAssigner(cfg.anchor_generator, cfg.grid_size, cfg.pc_range,
                              cfg.class_names, device=model.device)
    opt, lr_schedule = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, model)
    cap = GradCapture(opt)
    step = make_train_step(model, assigner, cap, cfg.loss_weights, cfg)
    b = model.batch_to_device(batch)
    if perturb_seed is not None:
        b = perturb_inputs(b, perturb_seed)
    _, tb = step(b)
    return step_record(model, cap, tb), float(lr_schedule(0))


def phase_small_reference_train(dev, cfg=TINY, batch=None, seed: int = TRAIN_REF_SEED):
    """TINY training step: card (kernels) vs CPU (plain versions), on
    ``batch`` (default ``tiny_batch()``), weights from ``seed``."""
    batch = tiny_batch() if batch is None else batch
    ref, lr = run_train_step(cfg, "cpu", batch, seed=seed)
    probes = [run_train_step(cfg, "cpu", batch, seed=seed, perturb_seed=s)[0]["grads"]
              for s in (1, 2)]
    got, _ = run_train_step(cfg, dev, batch, seed=seed)
    report = compare_steps(ref, got, sensitivity(ref["grads"], probes), lr)
    report["loss_terms_cpu"] = {k: float(v) for k, v in ref["tb"].items()}
    report["loss_terms_card"] = {k: float(v) for k, v in got["tb"].items()}
    print("  " + json.dumps(report))
    return report


def phase_small_reference_polar(dev):
    """The TINY polar model, card vs CPU: serving, then one training step."""
    return {"serve": phase_small_reference(dev, TINY_POLAR),
            "train": phase_small_reference_train(dev, TINY_POLAR)}


def phase_small_reference_xla(dev):
    """The TINY model under ``SAMPLER_KERNEL: xla``, card vs CPU: serving,
    then one training step, with the card's launches counted."""
    zero_launches()
    out = {"serve": phase_small_reference(dev, TINY_XLA),
           "train": phase_small_reference_train(dev, TINY_XLA)}
    out["launches"] = dict(library.launches)
    # the served frame: one fused launch and the NMS; the step: GATHER_STEP
    want = per_frames({**GATHER_STEP, library.REDUCE_KERNEL: 1, **NMS_CALL}, 1)
    print(f"  launches on the card: {out['launches']}")
    if out["launches"] != want:
        raise AssertionError(f"launches {out['launches']}, want {want}")
    return out


def phase_train(dev, cfg, per_step: dict, batch=None, keep_grads: bool = False):
    """3 full-width training steps of ``cfg`` after a warm-up, each launching
    the kernels ``per_step`` counts; ``batch`` defaults to
    ``flagship_batch(cfg)``. ``keep_grads``: the warm-up step's gradients,
    on the host, under the result's ``warmup_grads``."""
    model = HGSFusionModel(cfg, device=dev, seed=0)
    batch = model.batch_to_device(flagship_batch(cfg) if batch is None else batch)
    assigner = TargetAssigner(cfg.anchor_generator, cfg.grid_size, cfg.pc_range,
                              cfg.class_names, device=dev)
    positives = int((assigner(batch["gt_boxes"])["box_cls_labels"] > 0).sum())
    if positives == 0:
        raise AssertionError("no anchor is positive for the synthetic gt boxes")
    opt, _ = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, model)
    cap = GradCapture(opt)
    step = make_train_step(model, assigner, cap, cfg.loss_weights, cfg)
    params = dict(model.named_parameters())
    trainable = [k for k, p in params.items() if p.requires_grad]
    frozen = {k: p.detach().clone() for k, p in params.items() if k.startswith(FROZEN_PREFIX)}
    before = {k: p.detach().clone() for k, p in params.items() if p.requires_grad}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith(FROZEN_PREFIX) and k.endswith(("running_mean", "running_var"))}

    _, warm = step(batch)  # warm-up: cuDNN plans, allocator
    moving = {k for k, g in zip(trainable, cap.grads)
              if bool(before[k].any()) or (g is not None and bool(g.any()))}
    warm_grads = {k: (torch.zeros_like(params[k]) if g is None else g).float().cpu()
                  for k, g in zip(trainable, cap.grads)} if keep_grads else None
    cap.grads = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: 3 training steps
    zero_launches()
    wall, terms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        _, tb = step(batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        terms.append({k: float(v) for k, v in tb.items()})
    launches = dict(library.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = per_frames(per_step, 3)
    if launches != want:
        raise AssertionError(f"launches in 3 steps {launches}, want {want}")
    for t in terms:
        if not all(math.isfinite(v) for v in t.values()):
            raise AssertionError(f"non-finite loss terms {t}")
    params = dict(model.named_parameters())
    for k, v in frozen.items():
        if not torch.equal(params[k], v):
            raise AssertionError(f"frozen backbone parameter {k} changed")
    still = sorted(k for k in moving if torch.equal(params[k], before[k]))
    if still:
        raise AssertionError(f"trainable tensors that did not move: {still}")
    state = model.state_dict()
    same = sorted(k for k, v in stats.items() if torch.equal(state[k], v))
    if same:
        raise AssertionError(f"backbone BN statistics that did not move: {same}")

    # one more step with CUDA's sync debugging on: the step never makes the
    # host wait for the device
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    if syncs:
        raise AssertionError("the training step made the host wait for the device at "
                             f"{sorted(set(syncs))}")
    # one more step under the profiler: device time by kernel
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    ops = sorted(((e.key, getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)) / 1e3, e.count)
                  for e in prof.key_averages()), key=lambda r: -r[1])
    result = {
        "steps": 3, "launches": launches, "step_s": wall, "steps_per_s": 3 / sum(wall),
        "peak_memory_bytes": peak, "positive_anchors": positives, "loss_terms": terms,
        "warmup_loss_terms": {k: float(v) for k, v in warm.items()},
        **({"warmup_grads": warm_grads} if keep_grads else {}),
        "trainable_tensors": len(before), "moved": len(moving), "frozen_tensors": len(frozen),
        "profiled_step_device_ms": sum(ms for _, ms, _ in ops),
        "profiled_step_top": [{"op": k[:90], "device_ms": ms, "calls": n}
                              for k, ms, n in ops[:15]],
    }
    print("  " + json.dumps({k: v for k, v in result.items() if k != "warmup_grads"}))
    return result


# the paths whose launches the kernels line counts, each taken with the
# counters at 0 just before it
MAIN_PATHS = ("serve", "train", "serve_polar", "train_polar", "eval", "eval_polar", "train_cli",
              "bench_scatter", "serve_tj4d", "serve_tj4d_polar", "train_cli_tj4d",
              "eval_tj4d_polar", "export_serve", "export_serve_polar", "rhgm", "ddp",
              "eval_multiproc", "tta", "study_small", "serve_depth", "train_depth",
              "train_cli_depth", "export_serve_depth", "serve_q8", "train_q8", "eval_q8",
              "export_serve_q8", "serve_w8a8", "serve_w8a8_polar", "serve_occ_v2",
              "train_occ_v2", "serve_radar", "train_radar", "train_cli_radar",
              "serve_pp_multihead", "train_pp_multihead", "demo", "serve_bevfusion",
              "train_bevfusion", "train_cli_bevfusion", "serve_transfusion",
              "train_cli_transfusion", "serve_centerpoint", "serve_centerpoint_res2d",
              "serve_second", "serve_voxelnext", "serve_voxelnext2d",
              "serve_centerpoint_nuscenes", "train_centerpoint", "train_second",
              "train_voxelnext", "train_centerpoint_nuscenes", "train_cli_centerpoint",
              "train_cli_second", "serve_second_focal", "serve_second_iou", "serve_voxelrcnn",
              "train_second_focal", "train_second_iou", "train_voxelrcnn",
              "train_cli_voxelrcnn", "train_cli_second_iou", "serve_pvrcnn", "serve_pvrcnnpp",
              "train_pvrcnn", "train_pvrcnnpp", "train_cli_pvrcnn", "serve_parta2",
              "train_parta2", "train_cli_parta2")


def per_frames(per_frame: dict, frames: int) -> dict:
    """Every counter of ``library.launches`` after ``frames`` frames that
    each launch ``per_frame`` (the counters it does not name: 0)."""
    return {k: frames * per_frame.get(k, 0) for k in library.launches}


# launches per served or evaluated frame: the gather view's two groups in
# one fused launch, the polar view's three samples; under USE_DEPTH two
# depth-weighted samples (no fused kernel); and the batch's NMS
GATHER_FRAME = {library.REDUCE_KERNEL: 1, **NMS_CALL}
POLAR_FRAME = {library.KERNEL: 3, **NMS_CALL}
DEPTH_FRAME = {library.DEPTH_KERNEL: 2, **NMS_CALL}
# launches per training step with REMAT on (the configs' default): the
# gather view's two samples and their bins once more in the backward pass;
# the polar view recomputes pass 2, which launches no kernel
GATHER_STEP = {library.KERNEL: 4, library.BWD_KERNEL: 2, library.BINS: 4}
POLAR_STEP = {library.KERNEL: 3, library.BWD_KERNEL: 3, library.BINS: 3}
DEPTH_STEP = {library.DEPTH_KERNEL: 4, library.BWD_KERNEL: 2, library.BINS: 4,
              library.DEPTH_BWD_KERNEL: 2}
DEPTH_STEP_NO_REMAT = {library.DEPTH_KERNEL: 2, library.BWD_KERNEL: 2, library.BINS: 2,
                       library.DEPTH_BWD_KERNEL: 2}


def phase_serve(dev, cfg, per_frame: dict, batch=None):
    """3 full-width frames of ``cfg`` through ``serve()`` after a warm-up,
    each launching the kernels ``per_frame`` counts, then one staged frame;
    ``batch`` defaults to ``flagship_batch(cfg)``."""
    t0 = time.perf_counter()
    model = HGSFusionModel(cfg, device=dev, seed=0)
    build_s = time.perf_counter() - t0
    batch = flagship_batch(cfg) if batch is None else batch
    stages = ("backbone", "view_transform", "radar_branch", "fusion_head", "post_process")

    model.serve(batch)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: 3 frames through the serving entry point
    zero_launches()
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        dets = model.serve(batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    launches = dict(library.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = per_frames(per_frame, 3)
    if launches != want:
        raise AssertionError(f"launches in 3 frames {launches}, want {want}")
    n_valid = int(dets["valid"].sum())
    assert dets["boxes"].shape == (1, cfg.nms_post_max_size, 7), dets["boxes"].shape
    assert 0 <= n_valid <= cfg.nms_post_max_size
    assert bool(torch.isfinite(dets["boxes"][dets["valid"]]).all())

    # one more frame through the serve stages, with CUDA events between them
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    with torch.inference_mode():
        b = model.batch_to_device(batch)
        ev[0].record()
        feats, depth = model.image_features(b)
        ev[1].record()
        image_bev = model.view_transform(feats, b, depth)
        ev[2].record()
        radar_bev = model.radar_branch(b)
        ev[3].record()
        preds = model.fusion_and_head(image_bev, radar_bev)
        ev[4].record()
        staged = model.post_process(preds)
        ev[5].record()
    ev[5].synchronize()
    for k, v in preds.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite head output {k}")
    if not torch.equal(staged["valid"], dets["valid"]):
        raise AssertionError("the staged frame kept other boxes than serve()")
    # the post-process's worst case: every anchor passes the score threshold,
    # so 4096 candidates enter the NMS and up to 500 are kept; the last call
    # with every host-synchronizing call an error (none is left)
    with torch.inference_mode():
        worst_ms = cuda_ms(lambda: post_process(
            preds, model.anchors, model.box_coder, cfg, 0.0, cfg.nms_thresh,
            cfg.nms_pre_max_size, cfg.nms_post_max_size), iters=3, warmup=1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            worst = post_process(preds, model.anchors, model.box_coder, cfg, 0.0,
                                 cfg.nms_thresh, cfg.nms_pre_max_size, cfg.nms_post_max_size)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    result = {
        "frames": 3, "launches": launches,
        "frame_s": wall, "frames_per_s": 3 / sum(wall),
        "stage_ms": {s: ev[i].elapsed_time(ev[i + 1]) for i, s in enumerate(stages)},
        "peak_memory_bytes": peak, "valid_boxes": n_valid,
        "post_process_all_candidates_ms": worst_ms,
        "post_process_all_candidates_kept": int(worst["valid"].sum()),
        "model_build_s": build_s,
        "head_shapes": {k: list(v.shape) for k, v in preds.items()},
    }
    print("  " + json.dumps(result))
    return result


EVAL_FRAMES = 8
TINY_EVAL_FRAMES = 4
EVAL_BOX_TOL, EVAL_RESULT_TOL = 1e-4, 1e-6


def tiny_eval_config(root) -> dict:
    """``configs/hgsfusion_vod.yaml``'s data and post-processing blocks
    (``vod_dataset_config``) cut to TINY's range, voxels, image and point
    budget, over the tree at ``root``."""
    cfg = vod_dataset_config(root)
    data = cfg["DATA_CONFIG"]
    data.update(POINT_CLOUD_RANGE=list(TINY.pc_range), IMAGE_SIZE=list(TINY.image_size),
                MAX_POINTS=1024, MAX_GT_BOXES=16, VIRTUAL_POINT_PREFIX="virtual_points")
    data["DATA_PROCESSOR"][1]["VOXEL_SIZE"] = list(TINY.voxel_size)
    return cfg


def tie_free_threshold(scores, min_gap: float, per_frame: int) -> float:
    """A score threshold about ``per_frame`` candidates of each frame pass,
    such that no two passing scores of a frame, and no score and the
    threshold, are within ``min_gap``: exact ties would be ordered
    differently by the two devices' top-k."""
    pooled = np.sort(np.concatenate(scores))[::-1]
    k = per_frame * len(scores)
    thr = float(pooled[k - 1] + pooled[k]) / 2
    for s in scores:
        kept = np.sort(s[s >= thr])
        if kept.size == 0:
            raise AssertionError("a frame has no candidate above the threshold")
        if kept.size > 1 and np.diff(kept).min() <= min_gap:
            raise AssertionError(f"two passing scores within {min_gap}")
        if np.abs(s - thr).min() <= min_gap:
            raise AssertionError(f"a score within {min_gap} of the threshold")
    return thr


def phase_small_reference_eval(dev):
    """The TINY model through ``run_eval``: card (kernel) vs CPU (plain
    sampler), same weights and frames."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        make_synthetic_kitti(root, num_frames=TINY_EVAL_FRAMES, num_points=256,
                             num_virtual=64, image_hw=TINY.image_size, structured=True)
        cfg = tiny_eval_config(root)
        create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
        return compare_run_eval(dev, cfg, TINY, per_frame=8)


def compare_run_eval(dev, cfg, model_cfg, per_frame: int):
    """``run_eval`` of the ``model_cfg`` model (weights seed 5) over the
    dataset of ``cfg`` (its tree and infos written): card (kernel) vs CPU
    (plain sampler), at a tie-free score threshold of about ``per_frame``
    candidates a frame."""
    logger = create_logger()
    models = {"cpu": HGSFusionModel(model_cfg, device="cpu", seed=5),
              "card": HGSFusionModel(model_cfg, device=dev, seed=5)}
    ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False, logger=logger)
    scores = {}
    with torch.inference_mode():
        for name, m in models.items():
            scores[name] = [torch.sigmoid(m(m.batch_to_device(ds.collate_batch([ds[i]])))[
                "cls_preds"].float().reshape(-1, model_cfg.num_class)).max(-1).values.cpu().numpy()
                for i in range(len(ds))]
    score_diff = max(float(np.abs(a - b).max()) for a, b in zip(scores["cpu"], scores["card"]))
    min_gap = 10 * score_diff
    thr = tie_free_threshold(scores["cpu"], min_gap, per_frame=per_frame)
    out = {}
    for name, m in models.items():
        m.cfg = dataclasses.replace(model_cfg, score_thresh=thr, nms_pre_max_size=512,
                                    nms_post_max_size=100)
        ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False,
                           logger=logger)
        out[name] = run_eval(cfg, m, ds, logger)
    (ref, ref_res, _), (got, got_res, stats) = out["cpu"], out["card"]
    if [a["frame_id"] for a in got] != [a["frame_id"] for a in ref]:
        raise AssertionError("the card's frames differ from the CPU's")
    box_err = 0.0
    for g, r in zip(got, ref):
        if list(g["name"]) != list(r["name"]):
            raise AssertionError(f"frame {g['frame_id']}: other boxes kept on the card")
        if len(r["name"]):
            box_err = max(box_err, float(np.abs(g["boxes_lidar"] - r["boxes_lidar"]).max()))
    res_err = max(abs(got_res[k] - ref_res[k]) for k in ref_res)
    result = {"frames": len(got), "boxes": sum(len(a["name"]) for a in got),
              "score_thresh": thr, "score_max_abs_err": score_diff, "min_gap": min_gap,
              "box_max_abs_err": box_err, "result_max_abs_err": res_err,
              "launches_per_batch": stats["launches_per_batch"]}
    print("  " + json.dumps(result))
    if result["boxes"] == 0:
        raise AssertionError("no box passed the threshold")
    if not box_err <= EVAL_BOX_TOL or not res_err <= EVAL_RESULT_TOL:
        raise AssertionError(f"card vs CPU: boxes {box_err}, result dict {res_err}")
    return result


def annos_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k] for k in a)


def write_tree(root, data, frames: int):
    """A structured synthetic tree of ``frames`` full-width frames (2048
    radar and 4096 virtual points, ``data``'s image size and virtual-point
    prefix) in the format of ``data``'s dataset, VoD or TJ4D."""
    kw = dict(num_frames=frames, num_points=2048, num_virtual=4096,
              image_hw=tuple(data["IMAGE_SIZE"]), virtual_prefix=data["VIRTUAL_POINT_PREFIX"])
    if data["DATASET"] == "TJ4DDataset":
        return make_synthetic_tj4d(root, **kw)
    return make_synthetic_kitti(root, structured=True, **kw)


# each dataset's headline number in the result dict
HEADLINE = {"VODDataset": "entire_area/mAP_3d", "TJ4DDataset": "KITTI/Overall_3D_moderate"}


def phase_eval(dev, yaml_path, per_frame: dict, preset=None, frames: int = EVAL_FRAMES):
    """``run_eval`` over a ``frames``-frame synthetic tree of the config's
    dataset at full width, then the same frames through ``serve`` one by
    one; the config must equal ``preset`` where one is given."""
    cfg = load_config(yaml_path)
    model_cfg = model_config_from_yaml(cfg)
    if preset is not None and model_cfg != preset:
        raise AssertionError(f"{yaml_path} differs from its preset")
    data = cfg["DATA_CONFIG"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        data["DATA_PATH"] = str(root)
        t0 = time.perf_counter()
        write_tree(root, data, frames)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        create_infos(data, cfg["CLASS_NAMES"])
        infos_s = time.perf_counter() - t0
        logger = create_logger()
        ds = build_dataset(data, cfg["CLASS_NAMES"], training=False, logger=logger)
        model = HGSFusionModel(model_cfg, device=dev, seed=0)
        # random weights score every anchor near 0.0125, under the config's
        # SCORE_THRESH of 0.1, and would keep no box: the threshold goes to
        # the middle of the first frame's 12th and 13th best scores, so the
        # NMS, the annotations, the recall and the AP have boxes to work on
        with torch.inference_mode():
            preds = model(model.batch_to_device(ds.collate_batch([ds[0]])))
        scores = torch.sigmoid(preds["cls_preds"].float().reshape(-1, model_cfg.num_class))
        top = torch.topk(scores.max(-1).values, 13).values.cpu().numpy()
        thr = float(top[11] + top[12]) / 2
        model.cfg = dataclasses.replace(model_cfg, score_thresh=thr)
        model.serve(ds.collate_batch([ds[0]]))  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # the main path: the evaluation loop over every frame
        zero_launches()
        t0 = time.perf_counter()
        annos, result_dict, stats = run_eval(cfg, model, ds, logger, batch_size=1,
                                             infer_time=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(library.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        want = per_frames(per_frame, frames)
        if launches != want:
            raise AssertionError(f"launches in {frames} frames {launches}, want {want}")
        per_batch = per_frames(per_frame, 1)
        if any(b != per_batch for b in stats["launches_per_batch"]):
            raise AssertionError(f"launches per frame {stats['launches_per_batch']}")

        # the same frames through serve, one by one: the same annotations,
        # and serve's own time on a batch already on the card
        serve_ms = []
        for i in range(len(ds)):
            batch = ds.collate_batch([ds[i]])
            on_card = model.batch_to_device(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = model.serve(on_card)
            torch.cuda.synchronize()
            serve_ms.append((time.perf_counter() - t1) * 1e3)
            ref = ds.generate_prediction_dicts(batch, detections_to_pred_dicts(out),
                                               ds.class_names)[0]
            if not annos_equal(annos[i], ref):
                raise AssertionError(f"frame {i}: run_eval's annotations differ from serve's")
        points = int(ds[0]["points_valid"].sum())
    if not any(len(a["name"]) for a in annos):
        raise AssertionError("no frame kept a box")
    values = list(result_dict.values())
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in values):
        raise AssertionError(f"an AP outside [0, 100]: {result_dict}")
    if not all(0 <= c <= stats["total_gt"] for c in stats["recall"].values()):
        raise AssertionError(f"recall counts {stats['recall']} of {stats['total_gt']}")
    steady = serve_ms[2:]
    result = {
        "frames": len(annos), "launches": launches,
        "points_per_frame": points,
        "score_thresh": thr, "boxes": sum(len(a["name"]) for a in annos),
        "pipelined_ms_per_frame": stats["ms_per_frame"],
        "pipelined_frames_per_s": 1e3 / stats["ms_per_frame"],
        "serve_ms_per_frame": float(np.mean(steady)),
        "serve_frames_per_s": 1e3 / float(np.mean(steady)),
        "host_ms_per_frame": stats["host_ms_per_frame"],
        "h2d_device_ms_per_frame": stats["h2d_device_ms_per_frame"],
        "eval_s": stats["eval_s"], "run_eval_wall_s": wall_s,
        "tree_write_s": write_s, "create_infos_s": infos_s,
        "recall": {str(k): v for k, v in stats["recall"].items()}, "total_gt": stats["total_gt"],
        "peak_memory_bytes": peak, "headline": HEADLINE[data["DATASET"]],
        "headline_value": result_dict[HEADLINE[data["DATASET"]]],
    }
    print("  " + json.dumps(result))
    return result


# -- the serving entry points --------------------------------------------------
# the serving host's batches: 3 flagship frames (seeds 0-2), each written 3
# times so that its completion gaps reach the steady state
EXPORT_FRAMES, EXPORT_REPEATS = 3, 2
# a serving host that imports no model code (nor JAX): run as
# ``python -c SERVE_GUARD <serve.py's arguments>``
SERVE_GUARD = r"""
import importlib.abc, runpy, sys
BLOCKED = ("jax", "jaxlib", "hgsfusion_tpu", "hgsfusion_tpu_torch.models")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("the serving host imported " + name)
sys.meta_path.insert(0, Block())
sys.argv[0] = "serve"
runpy.run_module("hgsfusion_tpu_torch.tools.serve", run_name="__main__")
"""
# the same host serving several artifacts in one process, one
# ``tools/serve.py`` run each: ``python -c SERVE_GUARD_RUNS <JSON list of
# serve.py argument lists>``; a line "SERVED <summary JSON>" after each
SERVE_GUARD_RUNS = SERVE_GUARD.replace(
    'sys.argv[0] = "serve"\nrunpy.run_module("hgsfusion_tpu_torch.tools.serve", '
    'run_name="__main__")\n', """import json
from hgsfusion_tpu_torch.tools import serve
for argv in json.loads(sys.argv[1]):
    print("SERVED " + json.dumps(serve.main(argv)), flush=True)
""")
REPO = Path(__file__).resolve().parent


def start_serving_host_run(artifact, inputs, out_dir, env=None):
    """``tools/serve.py`` started in a subprocess that blocks the model code
    and JAX (``env``: its environment, default this one's), to be finished
    by ``run_serving_host``."""
    return subprocess.Popen([sys.executable, "-c", SERVE_GUARD, "--artifact", str(artifact),
                             "--inputs", str(inputs), "--out_dir", str(out_dir), "--time"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env=env)


def run_serving_host(artifact, inputs, out_dir, timeout: int = 600, env=None, proc=None):
    """A serving-host run (``proc``, from ``start_serving_host_run`` with
    these arguments; else started now) waited for: its JSON summary (its
    last line) and the detections, by input stem."""
    proc = proc or start_serving_host_run(artifact, inputs, out_dir, env)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"the serving host failed:\n{stdout[-2000:]}{stderr[-4000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    summary["stdout"] = stdout.strip().splitlines()[:-1]
    dets = {}
    for path in sorted(Path(out_dir).glob("*_dets.npz")):
        with np.load(path) as d:
            dets[path.name[:-len("_dets.npz")]] = {k: d[k] for k in d.files}
    return summary, dets


# candidates a frame above the export phases' score threshold, and the gap
# kept around each (the artifact and serve run the same kernels on one card)
EXPORT_PER_FRAME, EXPORT_MIN_GAP = 12, 1e-6


def tie_free_serving_threshold(model, frames) -> float:
    """``tie_free_threshold`` over the frames' eager scores."""
    scores = []
    with torch.inference_mode():
        for f in frames:
            cls = model(model.batch_to_device(f))["cls_preds"].float()
            scores.append(torch.sigmoid(cls.reshape(-1, model.cfg.num_class)).amax(-1)
                          .cpu().numpy())
    return tie_free_threshold(scores, EXPORT_MIN_GAP, EXPORT_PER_FRAME)


def pipelined_ms(serve_fn, frames) -> list:
    """``tools/serve.py``'s loop on ``serve_fn``: frame i + 1 dispatched
    before frame i is fetched; the gaps between completions (ms)."""
    gaps, last, pending = [], None, None

    def finish(dets):
        nonlocal last
        {k: v.cpu() for k, v in dets.items()}
        now = time.perf_counter()
        if last is not None:
            gaps.append((now - last) * 1e3)
        last = now

    for f in frames:
        dets = serve_fn(f)
        if pending is not None:
            finish(pending)
        pending = dets
    finish(pending)
    return gaps


# the exported artifacts that the serving host has still to serve, by
# name: (its work directory, the launches it must make, serve's detections,
# the result dict its numbers join); and the phase results whose launches
# take those of an artifact's serving run (a CLI phase that exported one)
PENDING_HOST = {}
HOST_OWNERS = {}


def phase_export_serve(dev, name: str, cfg, per_frame: dict):
    """``cfg`` at full width (random weights, seed 0) exported by
    ``tools/export.py``'s ``export_model`` on the flagship batch and saved;
    3 flagship frames (seeds 0-2), each as 2 ``.npz`` files, and
    ``serve``'s detections of each at a tie-free score threshold baked into
    both are left for ``phase_serving_host``, which serves every export
    phase's artifact from one serving-host process. Here: the export's and
    the save's seconds, the artifact's bytes, ms per frame by completion
    gaps through ``serve`` on the same numpy frames, and through the
    artifact loaded in this process and ``serve`` on the frames already on
    the card."""
    model = HGSFusionModel(cfg, device=dev, seed=0)
    frames = [flagship_batch(cfg, seed=s) for s in range(EXPORT_FRAMES)]
    thr = tie_free_serving_threshold(model, frames)
    model.cfg = dataclasses.replace(cfg, score_thresh=thr)
    t0 = time.perf_counter()
    program, spec = export_cli.export_model(model, frames[0])
    export_s = time.perf_counter() - t0
    nodes = sorted({str(n.target) for n in program.graph.nodes
                    if library.NAMESPACE in str(n.target)})
    graph_nodes = sum(n.op == "call_function" for n in program.graph.nodes)
    work = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
    t0 = time.perf_counter()
    size = export_cli.save_artifact(program, spec, work / "model.pt2")
    save_s = time.perf_counter() - t0
    del program
    (work / "in").mkdir()
    for r in range(EXPORT_REPEATS):
        for i, f in enumerate(frames):
            np.savez(work / "in" / f"r{r}_frame{i}.npz", **{k: f[k] for k in spec["inputs"]})
    # the artifact in this process on batches already on the card: its
    # graph against serve, without the host's file reads and copies
    module, _ = serve_cli.load_artifact(work / "model.pt2")
    on_card = [serve_cli.batch_inputs(f, spec) for f in frames] * EXPORT_REPEATS

    def artifact(batch):
        with torch.inference_mode():
            return module(batch)

    artifact(on_card[0])  # warm-up
    artifact_gaps = pipelined_ms(artifact, on_card)
    del module
    model.serve(frames[0])  # warm-up
    serve_gaps = pipelined_ms(model.serve, frames * EXPORT_REPEATS)
    serve_card_gaps = pipelined_ms(model.serve, on_card)
    refs = [{k: v.cpu().numpy() for k, v in model.serve(f).items()} for f in frames]
    result = {"graph_ops": nodes, "score_thresh": thr,
              "kept": [int(r["valid"].sum()) for r in refs],
              "export_s": export_s, "save_s": save_s, "artifact_bytes": size,
              "serve_ms_per_frame": float(np.mean(serve_gaps)), "serve_gaps_ms": serve_gaps,
              "on_card_artifact_ms_per_frame": float(np.mean(artifact_gaps)),
              "on_card_serve_ms_per_frame": float(np.mean(serve_card_gaps)),
              "graph_nodes": graph_nodes, "inputs": spec["inputs"]}
    if not all(result["kept"]):
        raise AssertionError(f"kept {result['kept']}")
    PENDING_HOST[name] = (work, per_frames(per_frame, EXPORT_FRAMES * EXPORT_REPEATS), refs,
                          result)
    print("  " + json.dumps(result))
    return result


def start_serving_host():
    """Every pending export phase's artifact handed to one serving-host
    subprocess (``tools/serve.py`` behind ``SERVE_GUARD_RUNS``, one run each
    over its ``.npz`` files), started now, its output to temporary files:
    -> (the process, its stdout and stderr files, the artifacts' names, their
    pending entries, the start time)."""
    if not PENDING_HOST:
        raise AssertionError("no export phase left an artifact to serve")
    names = list(PENDING_HOST)
    runs = [["--artifact", str(PENDING_HOST[n][0] / "model.pt2"), "--inputs",
             str(PENDING_HOST[n][0] / "in"), "--out_dir", str(PENDING_HOST[n][0] / "out"),
             "--time"] for n in names]
    logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen([sys.executable, "-c", SERVE_GUARD_RUNS, json.dumps(runs)],
                            stdout=logs[0], stderr=logs[1], text=True, cwd=REPO)
    pending = {n: PENDING_HOST.pop(n) for n in names}
    return proc, logs, names, pending, time.perf_counter()


def finish_serving_host(host) -> dict:
    """Wait for a ``start_serving_host`` process and check it: each run's
    launches (after its warm-up) must read its view's per-frame launches
    for each file, and its detections equal ``serve``'s (valid and labels
    equal, boxes and scores within 1e-4). Each export phase's result gains
    its launches, the host's ms per frame and gaps and the errors."""
    proc, logs, names, pending, t0 = host
    try:
        try:
            proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        host_s = time.perf_counter() - t0
        for f in logs:
            f.seek(0)
        stdout, stderr = (f.read() for f in logs)
        served = [json.loads(s[len("SERVED "):]) for s in stdout.splitlines()
                  if s.startswith("SERVED ")]
        if proc.returncode != 0 or len(served) != len(names):
            raise AssertionError(f"the serving host failed:\n{stdout[-2000:]}{stderr[-4000:]}")
        for name, summary in zip(names, served):
            work, want, refs, result = pending[name]
            if summary["launches"] != want:
                raise AssertionError(f"{name}: the artifact's launches {summary['launches']}, "
                                     f"want {want}")
            errs = {"boxes": 0.0, "scores": 0.0}
            repeats = len(list((work / "in").glob("*.npz"))) // len(refs)
            for i, ref in enumerate(refs):
                for r in range(repeats):
                    with np.load(work / "out" / f"r{r}_frame{i}_dets.npz") as got:
                        for k in ("valid", "labels"):
                            if not np.array_equal(got[k], ref[k]):
                                raise AssertionError(f"{name} frame {i}: the artifact's {k} "
                                                     "differ from serve's")
                        for k in errs:
                            errs[k] = max(errs[k], float(np.abs(got[k] - ref[k]).max()))
            if max(errs.values()) > 1e-4:
                raise AssertionError(f"{name}: max abs err {errs}")
            result.update(launches=summary["launches"], max_abs_err=errs,
                          artifact_ms_per_frame=summary["ms_per_frame"],
                          artifact_gaps_ms=summary["gaps_ms"], serving_host_s=host_s)
            owner = HOST_OWNERS.pop(name, None)
            if owner is not None:
                owner["launches_by_run"]["serving_host"] = summary["launches"]
                for k, v in summary["launches"].items():
                    owner["launches"][k] += v
    finally:
        for f in logs:
            f.close()
        for work, *_ in pending.values():
            shutil.rmtree(work, ignore_errors=True)
    return {"artifacts": names, "serving_host_s": host_s}


# serving hosts started after the export phases, which serve their
# artifacts while the phases after them run (``serving_host`` waits for
# them); the hosts' own ms a frame then share the card with those phases
EARLY_HOST = []


def phase_serving_host_start(dev):
    """``start_serving_host`` for the artifacts pending now (the export
    phases'), left running; ``phase_serving_host`` checks it."""
    host = start_serving_host()
    EARLY_HOST.append(host)
    out = {"artifacts": host[2]}
    print("  " + json.dumps(out))
    return out


def phase_serving_host(dev):
    """Every export phase's artifact served by ``tools/serve.py`` in a
    subprocess that blocks the model code and JAX (``SERVE_GUARD_RUNS``),
    one run each over its ``.npz`` files, checked by
    ``finish_serving_host``: the early hosts' (``phase_serving_host_start``)
    and one more for any artifacts left since. This phase's result: each
    host's artifacts and seconds."""
    hosts = [EARLY_HOST.pop(0) for _ in list(EARLY_HOST)]
    if PENDING_HOST:
        hosts.append(start_serving_host())
    if not hosts:
        raise AssertionError("no export phase left an artifact to serve")
    out = {"hosts": []}
    try:
        while hosts:
            out["hosts"].append(finish_serving_host(hosts.pop(0)))
    finally:
        for proc, logs, *_ in hosts:
            proc.kill()
            proc.wait()
            for f in logs:
                f.close()
    print("  " + json.dumps(out))
    return out


# python -m hgsfusion_tpu_torch.bench runs: the polar default, the gather
# view, the trained-model regime, TJ4DRadSet
BENCH_RUNS = ((), ("--vod",), ("--realistic",), ("--tj4d",))


def run_bench(args):
    """``bench.main(args)`` in this process under PyTorch's default TF32
    settings, as ``python -m hgsfusion_tpu_torch.bench`` runs: (its return
    code, its stdout lines, its stderr's ``#`` notes)."""
    out, err = io.StringIO(), io.StringIO()
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(list(args))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    torch.cuda.empty_cache()
    return (rc, out.getvalue().strip().splitlines(),
            [s for s in err.getvalue().splitlines() if s.startswith("#")])


def phase_bench(dev):
    """The port's ``bench`` entry point, each of BENCH_RUNS through
    ``bench.main`` in this process: exactly one JSON line on stdout, with a
    positive value, its metric's name and unit and ``vs_baseline``, and the
    timed serve calls' kernel launches (its stderr) those of a gather or
    polar frame each."""
    lines = []
    for args in BENCH_RUNS:
        t0 = time.perf_counter()
        rc, out, notes = run_bench(args)
        if rc != 0 or len(out) != 1:
            raise AssertionError(f"bench {args}: rc {rc}\n{out[-20:]}\n{notes[-20:]}")
        line = json.loads(out[0])
        cfg_name = args[0][2:] if args and args[0] != "--realistic" else "vod_polar"
        name = bench.metric_name(cfg_name, 1, "--realistic" in args)
        if line.get("metric") != name or not line.get("value", 0) > 0 \
                or line.get("unit") != "frames/sec/chip" or "vs_baseline" not in line:
            raise AssertionError(f"bench {args}: {line}")
        line["stderr"] = notes
        launched = [json.loads(s[len("# launches "):]) for s in notes
                    if s.startswith("# launches ")]
        if len(launched) != 1:
            raise AssertionError(f"bench {args}: no launch counts on stderr")
        polar = bench.flagship_config(cfg_name).f2v_view == "polar"
        want = per_frames(POLAR_FRAME if polar else GATHER_FRAME,
                          launched[0]["serve_calls"])
        if launched[0]["counts"] != want:
            raise AssertionError(f"bench {args}: launches {launched[0]}, want {want}")
        line["run_s"] = time.perf_counter() - t0
        print("  " + json.dumps(line))
        lines.append(line)
    return lines


VOD_YAML = "configs/hgsfusion_vod.yaml"
TRAIN_CLI_FRAMES, TRAIN_CLI_STEPS, RESUME_STEPS, TRAIN_CLI_EVAL_FRAMES = 16, 20, 4, 4


def phase_train_cli(dev, yaml_path=VOD_YAML):
    """``tools/train.py`` and ``tools/test.py --ckpt_dir`` on the paper's
    own config at full width: train across an epoch boundary, resume,
    evaluate the newest checkpoint."""
    cfg = load_config(yaml_path)
    model_cfg = model_config_from_yaml(cfg)
    if model_cfg.f2v_sampler_kernel != "xla" or dataclasses.replace(
            model_cfg, f2v_sampler_kernel="pallas") != vod_pallas_config():
        raise AssertionError(f"{yaml_path} is not the pallas preset with SAMPLER_KERNEL: xla")
    data = cfg["DATA_CONFIG"]
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "data", Path(tmp) / "out"
        data["DATA_PATH"] = str(root)
        t0 = time.perf_counter()
        write_tree(root, data, TRAIN_CLI_FRAMES)
        create_infos(data, cfg["CLASS_NAMES"])
        tree_s = time.perf_counter() - t0
        common = ["--cfg_file", yaml_path, "--fix_random_seed", "--epochs", "2", "--workers", "4",
                  "--output_dir", str(out)]
        data_set = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]

        # the main path: the first training run
        zero_launches()
        first = train_cli.main(common + ["--max_steps", str(TRAIN_CLI_STEPS)] + data_set)
        first["launches"] = dict(library.launches)
        ckpt = CheckpointManager(Path(first["out_dir"]) / "ckpt")
        first_steps = ckpt.all_steps()

        # the resume: its restored state against the newest file
        run = train_cli.prepare(train_cli.parse_args(
            common + ["--max_steps", str(RESUME_STEPS), "--profile_steps",
                      f"{TRAIN_CLI_STEPS + 1}:{TRAIN_CLI_STEPS + 1}"] + data_set))
        saved = torch.load(ckpt.path(TRAIN_CLI_STEPS), map_location="cpu", weights_only=True)
        model_equal = all(torch.equal(v.cpu(), saved["model_state"][k])
                          for k, v in run.model.state_dict().items())
        opt = run.optimizer.state_dict()
        opt_equal = (torch.equal(opt["count"].cpu(), saved["optimizer_state"]["count"])
                     and all(torch.equal(a.cpu(), b) for key in ("mu", "nu")
                             for a, b in zip(opt[key], saved["optimizer_state"][key])))
        log = (Path(first["out_dir"]) / "train.log").read_text()
        zero_launches()
        second = train_cli.fit(run)
        second["launches"] = dict(library.launches)

        # the evaluation of the newest checkpoint
        zero_launches()
        t0 = time.perf_counter()
        evaluated = test_cli.main(["--cfg_file", yaml_path, "--ckpt_dir", str(ckpt.ckpt_dir),
                                   "--max_frames", str(TRAIN_CLI_EVAL_FRAMES), "--output_dir",
                                   str(out / "eval")] + data_set)
        eval_s = time.perf_counter() - t0
        eval_launches = dict(library.launches)
        final_steps = ckpt.all_steps()

    def check(ok, what):
        if not ok:
            failures.append(what)

    for name, r, steps in (("first", first, TRAIN_CLI_STEPS), ("resume", second, RESUME_STEPS)):
        want = per_frames(GATHER_STEP, steps)
        check(r["launches"] == want, f"{name}: launches {r['launches']}, want {want}")
        check(r["steps"] == steps and all(math.isfinite(v) for v in r["losses"]),
              f"{name}: {r['steps']} steps, losses {r['losses']}")
    check(first["augmentation"]["flipped"] > 0, "no flipped frame was fed")
    check(first["augmentation"]["aug_matrix"] > 0, "every lidar_aug_matrix was the identity")
    check(first_steps == [TRAIN_CLI_FRAMES, TRAIN_CLI_STEPS],
          f"checkpoints after the first run: {first_steps}")
    check(run.resumed_from == run.start_step == TRAIN_CLI_STEPS
          and f"auto-resumed from step {TRAIN_CLI_STEPS}" in log,
          f"resumed from {run.resumed_from} at step {run.start_step}")
    check(model_equal and opt_equal, f"restored state differs from the file: model "
          f"{model_equal}, optimizer {opt_equal}")
    check(second["end_step"] == TRAIN_CLI_STEPS + RESUME_STEPS, f"resume ended at "
          f"{second['end_step']}")
    check(second["profile_device_ms"] is not None and second["profile_device_ms"] > 0,
          f"profiled step device ms {second['profile_device_ms']}")
    check(final_steps == [TRAIN_CLI_FRAMES, TRAIN_CLI_STEPS, TRAIN_CLI_STEPS + RESUME_STEPS],
          f"checkpoints at the end: {final_steps}")
    eval_step = TRAIN_CLI_STEPS + RESUME_STEPS
    want = per_frames(GATHER_FRAME, TRAIN_CLI_EVAL_FRAMES)
    check(sorted(evaluated) == [eval_step], f"evaluated steps {sorted(evaluated)}")
    check(eval_launches == want, f"eval launches {eval_launches}, want {want}")
    result_dict, stats = evaluated.get(eval_step, ({}, {}))
    check(stats.get("frames") == TRAIN_CLI_EVAL_FRAMES
          and all(math.isfinite(v) and 0 <= v <= 100 for v in result_dict.values()),
          f"evaluation: {stats.get('frames')} frames, {result_dict}")

    waits = first["loader_wait_s"]
    result = {
        "config": yaml_path, "frames": TRAIN_CLI_FRAMES, "tree_and_infos_s": tree_s,
        "launches": {k: first["launches"][k] + second["launches"][k] + eval_launches[k]
                     for k in eval_launches},
        "launches_by_run": {"train": first["launches"], "resume": second["launches"],
                            "eval": eval_launches},
        "steps_per_s": first["steps_per_s"],
        "steps_per_s_excl_saves": first["steps_per_s_excl_saves"],
        "loader_wait_ms": {"mean": 1e3 * float(np.mean(waits[2:])),
                           "max": 1e3 * float(np.max(waits[2:])),
                           "first_two": [1e3 * w for w in waits[:2]]},
        "augmentation": first["augmentation"],
        "losses": first["losses"] + second["losses"],
        "profiled_step_device_ms": second["profile_device_ms"],
        "saves": first["saves"] + second["saves"], "resume_s": run.resume_s,
        "checkpoint_bytes": first["saves"][-1]["bytes"] if first["saves"] else None,
        "peak_memory_bytes": first["peak_memory_bytes"],
        "resume_steps_per_s": second["steps_per_s"],
        "checkpoints": final_steps, "restored_bit_equal": model_equal and opt_equal,
        "eval_s": eval_s, "eval_ms_per_frame": stats.get("ms_per_frame"),
        "eval_result": result_dict,
    }
    print("  " + json.dumps(result))
    if failures:
        raise AssertionError("; ".join(failures))
    return result


TJ4D_YAMLS = {"xla": "configs/hgsfusion_tj4d.yaml", "pallas": "configs/hgsfusion_tj4d_pallas.yaml",
              "polar": "configs/hgsfusion_tj4d_polar.yaml"}
# the TINY TJ4D model: 1 m voxels, nx 32, ny 40, nz 6, and a 50x80 image
TINY_TJ4D_RANGE = [0, -20, -4, 32, 20, 2]
TINY_TJ4D_FRAMES = 4
# the augmentation seed of the TINY TJ4D step's two frames: one whose step
# (weights TRAIN_REF_SEED) the CPU's own probes find well conditioned
# (step_compare.SENS_CAP: seed 1 at 2.8e-5 of the cap's 1e-3; seeds 3, 5
# and 6 over it)
TINY_TJ4D_TRAIN_SEED = 1
TJ4D_CLI_FRAMES, TJ4D_CLI_STEPS, TJ4D_CLI_EVAL_FRAMES = 16, 10, 4


def tiny_tj4d_cut(cfg, root):
    """A loaded ``hgsfusion_tj4d*.yaml`` cut to the TINY TJ4D model over the
    tree at ``root``: TINY_TJ4D_RANGE at 1 m, a 50x80 image, ResNet-50, 16
    depth bins to 32 m, f32; TJ4D's 4 classes, 8 anchors, 18 point
    features, ASPP dilation and BEV_AUG as they are."""
    data = cfg["DATA_CONFIG"]
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=list(TINY_TJ4D_RANGE),
                IMAGE_SIZE=[50, 80], MAX_POINTS=1024, MAX_GT_BOXES=16,
                VIRTUAL_POINT_PREFIX="virtual_points")
    data["DATA_PROCESSOR"][1]["VOXEL_SIZE"] = [1.0, 1.0, 1.0]
    model = cfg["MODEL"]
    model["COMPUTE_DTYPE"] = "float32"
    ffn = model["FusionVFE"]["ImageVFE"]["FFN"]
    ffn["DDN"]["BACKBONE_NAME"] = "ResNet50"
    ffn["DISCRETIZE"].update(num_bins=16, depth_max=32.0)
    model["FusionVFE"]["RadarBackbone"]["READER"]["PC_RANGE"] = list(TINY_TJ4D_RANGE)
    model["POST_PROCESSING"]["NMS_CONFIG"].update(NMS_PRE_MAXSIZE=512, NMS_POST_MAXSIZE=100)
    return cfg


def write_tiny_tj4d_tree(root):
    """TINY_TJ4D_FRAMES frames at 50x80 whose Car, Pedestrian, Cyclist and
    Truck (3 m to about 28 m) lie in TINY_TJ4D_RANGE."""
    return make_synthetic_tj4d(root, num_frames=TINY_TJ4D_FRAMES, num_points=256,
                               num_virtual=64, image_hw=(50, 80), num_boxes=4, box_x0=3.0,
                               box_spread=28.0)


def tj4d_config(view: str):
    """``configs/hgsfusion_tj4d{,_pallas,_polar}.yaml``'s model config."""
    return model_config_from_yaml(load_config(TJ4D_YAMLS[view]))


def tj4d_serve_batch(cfg):
    """``flagship_batch`` at TJ4D's image size, with the synthetic trees'
    intrinsics for that size (``make_calib``: the camera at the image's
    center)."""
    return flagship_batch(cfg, cam_to_img=make_calib(cfg.image_size)["P2"])


def phase_small_reference_tj4d(dev):
    """The TINY TJ4D model (``tiny_tj4d_cut`` of hgsfusion_tj4d_pallas.yaml),
    card vs CPU over a synthetic TJ4D tree: serving two frames (as
    ``phase_small_reference``), one training step at B=2 on two augmented
    frames with a Truck among their boxes (as ``phase_small_reference_train``;
    1 fused launch, then 4 forward, 2 backward and 4 bins on the card), then
    ``run_eval`` over the tree (as ``phase_small_reference_eval``)."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        write_tiny_tj4d_tree(root)
        cfg = tiny_tj4d_cut(load_config(TJ4D_YAMLS["pallas"]), root)
        create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
        model_cfg = model_config_from_yaml(cfg)
        if (model_cfg.grid_size, model_cfg.num_anchors_per_location) != ((32, 40, 6), 8):
            raise AssertionError(f"TINY TJ4D grid {model_cfg.grid_size}, "
                                 f"{model_cfg.num_anchors_per_location} anchors")
        ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False)
        train_ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=True)
        np.random.seed(TINY_TJ4D_TRAIN_SEED)
        train_batch = train_ds.collate_batch([train_ds[i] for i in range(2)])
        if not (train_batch["gt_boxes"][..., -1] == 4).any():
            raise AssertionError("no Truck among the training frames' boxes")
        zero_launches()
        out = {"serve": phase_small_reference(dev, model_cfg,
                                              ds.collate_batch([ds[i] for i in range(2)])),
               "train": phase_small_reference_train(dev, model_cfg, train_batch)}
        out["launches"] = dict(library.launches)
        want = per_frames({**GATHER_STEP, library.REDUCE_KERNEL: 1, **NMS_CALL}, 1)
        print(f"  launches on the card: {out['launches']}")
        if out["launches"] != want:
            raise AssertionError(f"launches {out['launches']}, want {want}")
        out["eval"] = compare_run_eval(dev, cfg, model_cfg, per_frame=7)
    return out


def phase_train_cli_tj4d(dev):
    """``tools/train.py`` on ``configs/hgsfusion_tj4d.yaml`` (SAMPLER_KERNEL:
    xla, BATCH_SIZE_PER_DEVICE: 2) at full width over a 16-frame synthetic
    TJ4D tree, across an epoch boundary (8 steps), its second step profiled
    (before the window of ``steps_per_s``, which starts at the third); then
    ``tools/test.py --ckpt_dir`` over 4 frames."""
    yaml_path = TJ4D_YAMLS["xla"]
    cfg = load_config(yaml_path)
    model_cfg = model_config_from_yaml(cfg)
    batch = cfg["OPTIMIZATION"]["BATCH_SIZE_PER_DEVICE"]
    if model_cfg.f2v_sampler_kernel != "xla" or batch != 2:
        raise AssertionError(f"{yaml_path}: sampler {model_cfg.f2v_sampler_kernel}, B={batch}")
    data = cfg["DATA_CONFIG"]
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "data", Path(tmp) / "out"
        data["DATA_PATH"] = str(root)
        t0 = time.perf_counter()
        write_tree(root, data, TJ4D_CLI_FRAMES)
        create_infos(data, cfg["CLASS_NAMES"])
        tree_s = time.perf_counter() - t0
        data_set = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
        # the main path: a training run
        zero_launches()
        run = train_cli.main(["--cfg_file", yaml_path, "--fix_random_seed", "--epochs", "2",
                              "--workers", "4", "--output_dir", str(out), "--max_steps",
                              str(TJ4D_CLI_STEPS), "--profile_steps", "1:1"]
                             + data_set)
        run["launches"] = dict(library.launches)
        ckpt = CheckpointManager(Path(run["out_dir"]) / "ckpt")
        steps = ckpt.all_steps()
        # the evaluation of the newest checkpoint
        zero_launches()
        t0 = time.perf_counter()
        evaluated = test_cli.main(["--cfg_file", yaml_path, "--ckpt_dir", str(ckpt.ckpt_dir),
                                   "--max_frames", str(TJ4D_CLI_EVAL_FRAMES), "--output_dir",
                                   str(out / "eval")] + data_set)
        eval_s = time.perf_counter() - t0
        eval_launches = dict(library.launches)

    def check(ok, what):
        if not ok:
            failures.append(what)

    want = per_frames(GATHER_STEP,
                      TJ4D_CLI_STEPS)
    check(run["launches"] == want, f"launches {run['launches']}, want {want}")
    check(run["steps"] == TJ4D_CLI_STEPS and all(math.isfinite(v) for v in run["losses"]),
          f"{run['steps']} steps, losses {run['losses']}")
    check(run["augmentation"]["frames"] == 2 * TJ4D_CLI_STEPS, f"frames fed "
          f"{run['augmentation']['frames']}")
    check(run["augmentation"]["flipped"] > 0, "no flipped frame was fed")
    check(run["augmentation"]["aug_matrix"] > 0, "every lidar_aug_matrix was the identity")
    epoch = TJ4D_CLI_FRAMES // batch
    check(steps == [epoch, TJ4D_CLI_STEPS], f"checkpoints {steps}")
    check(run["profile_device_ms"] is not None and run["profile_device_ms"] > 0,
          f"profiled step device ms {run['profile_device_ms']}")
    want = per_frames(GATHER_FRAME, TJ4D_CLI_EVAL_FRAMES)
    check(sorted(evaluated) == [TJ4D_CLI_STEPS], f"evaluated steps {sorted(evaluated)}")
    check(eval_launches == want, f"eval launches {eval_launches}, want {want}")
    result_dict, stats = evaluated.get(TJ4D_CLI_STEPS, ({}, {}))
    check(stats.get("frames") == TJ4D_CLI_EVAL_FRAMES and HEADLINE["TJ4DDataset"] in result_dict
          and all(math.isfinite(v) and 0 <= v <= 100 for v in result_dict.values()),
          f"evaluation: {stats.get('frames')} frames, {result_dict}")
    waits = run["loader_wait_s"]
    result = {
        "config": yaml_path, "frames": TJ4D_CLI_FRAMES, "batch_size": batch,
        "tree_and_infos_s": tree_s,
        "launches": {k: run["launches"][k] + eval_launches[k] for k in eval_launches},
        "launches_by_run": {"train": run["launches"], "eval": eval_launches},
        "steps": run["steps"], "steps_per_s": run["steps_per_s"],
        "steps_per_s_excl_saves": run["steps_per_s_excl_saves"],
        "loader_wait_ms": {"mean": 1e3 * float(np.mean(waits[2:])),
                           "max": 1e3 * float(np.max(waits[2:])),
                           "first_two": [1e3 * w for w in waits[:2]]},
        "augmentation": run["augmentation"], "losses": run["losses"],
        "profiled_step_device_ms": run["profile_device_ms"], "saves": run["saves"],
        "peak_memory_bytes": run["peak_memory_bytes"], "checkpoints": steps,
        "eval_s": eval_s, "eval_ms_per_frame": stats.get("ms_per_frame"),
        "eval_result": result_dict,
    }
    print("  " + json.dumps(result))
    if failures:
        raise AssertionError("; ".join(failures))
    return result


# ---------------------------------------------------------------------------
# RHGM: the Mask2Former segmentor and the hybrid-point tool
# ---------------------------------------------------------------------------

RHGM_IMAGE = (70, 100)  # small_reference_rhgm: not a multiple of any stride
# card vs CPU in f32 with TF32 off: logits within this; a binary mask pixel
# may differ only where the CPU's logit lies within it of 0, and two class
# scores within it of each other may take their top-k ranks in either order
RHGM_TOL = 1e-4
RHGM_FRAMES = 2  # after one warm-up frame
RHGM_RESIZE = 1024  # the reference predictor's MIN_SIZE_TEST: 516 x 1936 -> 1024 x 3842


def compare_instances(ref, got, image_hw, tol: float = RHGM_TOL) -> dict:
    """``instance_inference`` of two forwards of one model (``ref`` on the
    CPU, ``got`` on the card), compared rank by rank where the ranks are
    tie-free: the same label, the score within ``tol`` plus what the
    differing pixels move it, the binary mask equal but at pixels whose
    reference logit lies within ``tol`` of 0. Ranks whose class score lies
    within ``tol`` of a neighbour's are compared through the sorted class
    scores only."""
    k = ref["pred_logits"].shape[-1] - 1
    cls_ref = ref["pred_logits"][0].softmax(-1)[:, :-1].reshape(-1)
    cls_got = got["pred_logits"][0].cpu().softmax(-1)[:, :-1].reshape(-1)
    sorted_ref = torch.sort(cls_ref, descending=True).values
    torch.testing.assert_close(torch.sort(cls_got, descending=True).values, sorted_ref,
                               rtol=0, atol=tol)
    lab_r, sc_r, bin_r = instance_inference(ref["pred_logits"], ref["pred_masks"], image_hw)
    lab_g, sc_g, bin_g = (a.cpu() for a in instance_inference(
        got["pred_logits"], got["pred_masks"], image_hw))
    t = len(lab_r)
    near = (sorted_ref[:-1] - sorted_ref[1:]) < tol  # rank i ties rank i + 1
    tied = near[:t].clone()
    tied[1:] |= near[:t - 1]
    qidx = torch.topk(cls_ref, t).indices // k
    logits = resize_bilinear(ref["pred_masks"][0].permute(1, 2, 0)[None], image_hw)[0]
    flipped = 0
    for r in torch.nonzero(~tied)[:, 0].tolist():
        assert int(lab_g[r]) == int(lab_r[r]), f"rank {r}: label {int(lab_g[r])} vs {int(lab_r[r])}"
        diff = bin_g[r] != bin_r[r]
        n = int(diff.sum())
        if n:
            worst = float(logits[..., qidx[r]][diff].abs().max())
            assert worst < tol, f"rank {r}: a mask pixel flipped at logit {worst}"
            flipped += n
        denom = max(int(bin_r[r].sum()) - n, 1)
        assert abs(float(sc_g[r] - sc_r[r])) <= tol + n / denom, f"rank {r}: score"
    return {"ranks": t, "tied_ranks": int(tied.sum()), "flipped_pixels": flipped}


def phase_small_reference_rhgm(dev):
    """The tiny preset with either pixel decoder, weights from one seed, on
    the card against the CPU (f32, TF32 off): logits, mask logits, then
    instance_inference (``compare_instances``)."""
    img = torch.from_numpy(np.random.RandomState(3).rand(1, *RHGM_IMAGE, 3).astype(np.float32))
    out = {}
    for pd in ("msdeform", "fpn"):
        kw = dict(pixel_decoder=pd, seed=7, **ghp.PRESETS["tiny"])
        cpu_model = Mask2FormerInstance(device="cpu", **kw)
        card_model = Mask2FormerInstance(device=dev, **kw)
        with torch.inference_mode():
            ref = cpu_model(img)
            got = card_model(img.to(dev))
        errs = {k: float((got[k].cpu() - ref[k]).abs().max()) for k in ref}
        for k in ref:
            torch.testing.assert_close(got[k].cpu(), ref[k], rtol=0, atol=RHGM_TOL)
        out[pd] = {"max_abs_err": errs, **compare_instances(ref, got, RHGM_IMAGE)}
        print(f"  {pd}: " + json.dumps(out[pd]))
    return out


def _launches() -> dict:
    return {**library.launches, **row_scatter.launches}


def segmentor_flops(source, image) -> dict:
    """Multiply-add FLOPs (2 per MAC) of one segmentation, counted by
    ``torch.utils.flop_counter`` from this run's shapes: the whole forward
    and the backbone."""
    from torch.utils.flop_counter import FlopCounterMode

    source.model.requires_grad_(False)  # the counter's module hooks skip tensors without grad
    with FlopCounterMode(display=False) as counter:
        source.segment(image)
    by_module = counter.get_flop_counts()
    backbone = sum(n for name, ops in by_module.items()
                   if name.endswith(".backbone") for n in ops.values())
    return {"total": counter.get_total_flops(), "backbone": backbone}


def run_rhgm_tool(dev, argv, capture: bool):
    """``generate_hybrid_points.main(argv)`` with the peak device memory;
    with ``capture``, the model source's masks of each frame and the source
    itself."""
    captured = {"masks": [], "source": None}
    call = ghp.ModelMaskSource.__call__

    def keep(source, image):
        masks, labels = call(source, image)
        captured["masks"].append((masks, labels))
        captured["source"] = source
        return masks, labels

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    if capture:
        with mock.patch.object(ghp.ModelMaskSource, "__call__", keep):
            res = ghp.main(argv)
    else:
        res = ghp.main(argv)
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the RHGM path launched a kernel: {launches}")
    res["launches"] = launches
    res["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                                else None)
    return res, captured


def phase_rhgm(dev, preset: str = "large", image_hw=(516, 1936), tj4d_hw=(810, 1280),
               resize=RHGM_RESIZE, frames: int = RHGM_FRAMES):
    """The port's ``tools/generate_hybrid_points.py`` at full width on a
    synthetic VoD tree (one warm-up frame, then ``frames``): swin-L
    Mask2Former with the MSDeformAttn pixel decoder on 1024 x 3842 images,
    random weights from a seed. Random weights score no instance near the
    default 0.5, so the generator would do nothing: the threshold is 0 and
    every one of the 100 instances with a non-empty mask is kept. Then the
    tool with the precomputed source on the first run's masks: the same
    files. Then the VoD dataset reads them under the config's prefix, and
    one TJ4D frame (810 x 1280 PNG, 8 radar dims) goes through the model
    source at the tool's own size. No CUDA kernel of the port runs."""
    cfg = load_config(VOD_YAML)
    data = cfg["DATA_CONFIG"]
    prefix = data["VIRTUAL_POINT_PREFIX"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "vod"
        make_synthetic_kitti(root, num_frames=frames + 1, num_points=2048, num_virtual=64,
                             image_hw=image_hw, structured=True)
        common = ["--dataset", "vod", "--data_root", str(root), "--num_virtual", "100",
                  "--seed", "0", "--confidence_threshold", "0.0"]
        if tuple(image_hw) != ghp._DATASETS["vod"]["image_hw"]:
            common += ["--image_hw", str(image_hw[0]), str(image_hw[1])]
        model_args = ["--mask_source", "model", "--model_preset", preset,
                      "--pixel_decoder", "msdeform", "--device", str(dev)]
        res, captured = run_rhgm_tool(dev, common + model_args + [
            "--resize_shortest", str(resize), "--pts_save_path", str(root / "training" / prefix)],
            capture=True)
        source = captured["source"]
        steady = res["frames"][1:]
        image = ghp.read_rgb01(root / "training/image_2/00000.jpg")
        flops = segmentor_flops(source, image)
        seg_ms = float(np.mean([f["segment_ms"] for f in steady]))
        out["vod"] = {
            "model_hw": list(source.model_hw), "frames": res["frames"],
            "segment_ms": seg_ms, "copy_ms": float(np.mean([f["copy_ms"] for f in steady])),
            "generate_ms": float(np.mean([f["generate_ms"] for f in steady])),
            "frames_per_s": 1e3 / float(np.mean([f["frame_ms"] for f in steady])),
            "peak_memory_bytes": res["peak_memory_bytes"], "launches": res["launches"],
            "flops": flops, "bound_ms": flops["total"] / F32_FLOPS_PER_S * 1e3,
            "bound_by": "operations"}
        if tuple(source.model_hw) != (resize, round(image_hw[1] * resize / image_hw[0])):
            raise AssertionError(f"model input {source.model_hw}")
        if not all(f["virtual"] > 0 and f["real"] > 0 for f in res["frames"]):
            raise AssertionError(f"a frame without points: {res['frames']}")

        # the same masks through the precomputed source: the same files
        masks_dir = Path(tmp) / "masks"
        masks_dir.mkdir()
        for idx, (masks, labels) in zip(ghp.frame_ids(root, "train"), captured["masks"]):
            np.savez(masks_dir / f"{idx}.npz", masks=masks, labels=labels)
        pre, _ = run_rhgm_tool(dev, common + [
            "--mask_source", "precomputed", "--masks_dir", str(masks_dir),
            "--pts_save_path", str(Path(tmp) / "precomputed")], capture=False)
        for idx in ghp.frame_ids(root, "train"):
            a = (root / "training" / prefix / f"{idx}.pkl.npy").read_bytes()
            if a != (Path(tmp) / "precomputed" / f"{idx}.pkl.npy").read_bytes():
                raise AssertionError(f"frame {idx}: model and precomputed files differ")
        out["vod"]["precomputed_generate_ms"] = float(np.mean(
            [f["generate_ms"] for f in pre["frames"]]))

        # the VoD dataset reads them: virtual rows (flags 0, 1) among its points
        data["DATA_PATH"] = str(root)
        create_infos(data, cfg["CLASS_NAMES"])
        ds = build_dataset(data, cfg["CLASS_NAMES"], training=False, logger=create_logger())
        virtual_rows = []
        for i in range(len(ds)):
            item = ds[i]
            pts = item["points"][item["points_valid"].astype(bool)]
            width = np.load(root / "training" / prefix / f"{ds.infos[i]['point_cloud']['lidar_idx']}"
                            ".pkl.npy", allow_pickle=True).item()["virtual_points"].shape[1]
            if width != 15:
                raise AssertionError(f"VoD hybrid points {width} wide, want 15")
            virtual_rows.append(int(((pts[:, -2] == 0) & (pts[:, -1] == 1)).sum()))
        if not all(virtual_rows):
            raise AssertionError(f"virtual rows per frame {virtual_rows}")
        out["vod"]["dataset_virtual_rows"] = virtual_rows

        # one TJ4D frame at the tool's own size
        troot = Path(tmp) / "tj4d"
        make_synthetic_tj4d(troot, num_frames=1, num_points=2048, image_hw=tj4d_hw)
        targs = ["--dataset", "tj4d", "--data_root", str(troot), "--seed", "0",
                 "--confidence_threshold", "0.0", "--pts_save_path", str(troot / "hybrid")]
        if tuple(tj4d_hw) != ghp._DATASETS["tj4d"]["image_hw"]:
            targs += ["--image_hw", str(tj4d_hw[0]), str(tj4d_hw[1])]
        tres, _ = run_rhgm_tool(dev, targs + model_args, capture=False)
        f = next((troot / "hybrid").iterdir())
        d = np.load(f, allow_pickle=True).item()
        if d["virtual_points"].shape[1] != 16 or not len(d["virtual_points"]):
            raise AssertionError(f"TJ4D hybrid points {d['virtual_points'].shape}, want (>0, 16)")
        out["tj4d"] = {"frames": tres["frames"], "peak_memory_bytes": tres["peak_memory_bytes"],
                       "launches": tres["launches"]}
    out["launches"] = {k: out["vod"]["launches"][k] + out["tj4d"]["launches"][k]
                       for k in out["vod"]["launches"]}
    for name in ("vod", "tj4d"):
        for f in out[name]["frames"]:
            print(f"  {name} {f['id']}: segment {f['segment_ms']:.1f} ms, copy "
                  f"{f['copy_ms']:.1f} ms, generator {f['generate_ms']:.1f} ms, masks "
                  f"{f['masks']}, virtual {f['virtual']}, real {f['real']}")
    v = out["vod"]
    print(f"  vod: {v['frames_per_s']:.3f} frames/s through the tool, segmentor "
          f"{v['segment_ms']:.1f} ms against its bound {v['bound_ms']:.1f} ms "
          f"({v['flops']['total'] / 1e12:.2f} TFLOP, backbone "
          f"{v['flops']['backbone'] / 1e12:.2f}), peak {v['peak_memory_bytes']} B; "
          f"tj4d peak {out['tj4d']['peak_memory_bytes']} B")
    return out


# -- data-parallel training, multi-process evaluation, TTA, the study -----------
# the processes of a phase's process group on the one card talk over gloo,
# which takes CUDA tensors (NCCL refuses two ranks on one card)
RANKS = 2
# the weights of the ddp phase's B=2 comparisons, from ``ddp_conditioning``
# on the card. Full width: the seed whose one-process f32 step has the
# fewest tensors over step_compare.SENS_CAP (seeds 0-7: 3 tensors over at
# seed 6, 7-51 at the others). TINY: the best-conditioned seed (seeds 0-11:
# 0, 2, 7 and 8 under the cap, 7 at 3.1e-4 of a tensor's largest gradient;
# seed 1, the CPU test's, over it at 1.2e-3 on the card)
DDP_SEED, DDP_TINY_SEED = 6, 7
# the probes of their sensitivity: two put the full-width step's
# pred_occupancy.1.bias at 0.96 of SENS_CAP, eight at 1.32 (``ddp_noise``)
DDP_PROBES = 8


def _torchrun_env(port: int) -> dict:
    return {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def train_steps(ctx, cfg, batch, steps: int, seed: int, perturb_seed=None, deterministic=False):
    """``steps`` training steps of the model of ``cfg`` from ``seed`` (its
    backbone's residual scales at 0) on the card, on ``batch`` or, under a
    process group (``ctx`` active), this rank's slice of it through DDP.
    Returns each step's ``step_record``, the first step's learning rate,
    the steps' kernel launches and each step's ms. TF32 off; with
    ``deterministic`` cuDNN's deterministic algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    dev = ctx.device if ctx is not None and ctx.active else torch.device("cuda", 0)
    model = zero_residual_scales(HGSFusionModel(cfg, device=dev, seed=seed))
    assigner = TargetAssigner(cfg.anchor_generator, cfg.grid_size, cfg.pc_range,
                              cfg.class_names, device=dev)
    opt, lr_schedule = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, model)
    cap = GradCapture(opt)
    ddp = None
    if ctx is not None and ctx.active:
        ddp = mesh.wrap_model(model, ctx)
        batch = mesh.rank_slice(batch, ctx.rank, ctx.world_size)
    step = make_train_step(model, assigner, cap, cfg.loss_weights, cfg, ddp=ddp)
    b = model.batch_to_device(batch)
    if perturb_seed is not None:
        b = perturb_inputs(b, perturb_seed)
    records, ms = [], []
    zero_launches()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, tb = step(b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        records.append(step_record(model, cap, tb))
    launches = dict(library.launches)
    torch.backends.cudnn.deterministic = False
    return records, float(lr_schedule(0)), launches, ms


def _record_diff(a, b) -> float:
    """The largest |a - b| over every tensor of two step records."""
    return max(float((v.float() - b[part][k].float()).abs().max())
               for part in ("tb", "grads", "params", "stats") for k, v in a[part].items())


def phase_ddp(dev):
    """``configs/hgsfusion_vod.yaml`` at full width through the port's
    data-parallel training step (``parallel/mesh.py``, the synchronized
    BatchNorms, DDP): (a) world size 1 over NCCL, two steps, against the
    plain step, bit for bit (cuDNN deterministic; the plain step run twice
    gives its own spread, which the wrapped step is held to if it is not 0);
    (b) two ranks on the card over gloo at B=1 each, against one process at
    B=2 on the same two frames (``two_ranks_vs_one``), in f32 (TF32 off:
    ``train/step_compare.py``'s tolerances are f32's), the ranks equal to
    each other, at full width and on the TINY model, under the whole
    ``step_compare`` comparison. No weight seed gives a full-width step
    that the probes find well conditioned in every tensor
    (``ddp_conditioning``: 3 to 51 tensors over ``SENS_CAP`` at seeds 0-7),
    so the few over the cap are named and held to their measured
    tolerance."""
    cfg = model_config_from_yaml(load_config(VOD_YAML))
    batch = flagship_batch(cfg)
    seed = TRAIN_REF_SEED
    # (a) world size 1 over NCCL
    plain = [train_steps(None, cfg, batch, 2, seed, deterministic=True) for _ in range(2)]
    os.environ.update(_torchrun_env(spawn.free_port()))
    try:
        ctx = mesh.init_distributed("cuda", "nccl")
        try:
            wrapped = train_steps(ctx, cfg, batch, 2, seed, deterministic=True)
        finally:
            mesh.shutdown(ctx)
    finally:
        for k in _torchrun_env(0):
            os.environ.pop(k, None)
    spread = max(_record_diff(a, b) for a, b in zip(plain[0][0], plain[1][0]))
    diff = max(_record_diff(a, b) for a, b in zip(plain[0][0], wrapped[0]))
    if spread == 0.0 and diff != 0.0:
        raise AssertionError(f"world size 1: the wrapped step differs from the plain step by "
                             f"{diff}, the plain step is bit-reproducible")
    if diff > spread:
        raise AssertionError(f"world size 1: {diff} off, over the plain step's spread {spread}")
    want = per_frames(GATHER_STEP, 2)
    if wrapped[2] != want:
        raise AssertionError(f"world size 1: launches {wrapped[2]}, want {want}")
    torch.cuda.empty_cache()

    # (b) two gloo ranks at B=1 against one process at B=2, at full width
    # (DDP_SEED) and TINY (DDP_TINY_SEED)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gloo = dict(zip(("full", "tiny"), two_ranks_vs_one(
        [(cfg32, flagship_batch(cfg32, b=RANKS), DDP_SEED),
         (TINY, tiny_batch(RANKS), DDP_TINY_SEED)])))
    result = {
        "world1": {"bit_equal": diff == 0.0, "max_abs_diff": diff, "plain_spread": spread,
                   "steps": 2, "plain_ms": plain[0][3], "wrapped_ms": wrapped[3],
                   "loss": [float(r["tb"]["loss"]) for r in wrapped[0]]},
        "gloo2": gloo,
        "launches": {k: wrapped[2][k] + gloo["full"]["launches"][k] for k in library.launches},
    }
    print("  " + json.dumps(result))
    return result


def train_step_cases(ctx, cases):
    """``train_steps(ctx, cfg, batch, 1, seed)`` for each (cfg, batch, seed)
    of ``cases`` in turn, in one process group."""
    return [train_steps(ctx, cfg, batch, 1, seed) for cfg, batch, seed in cases]


def two_ranks_vs_one(cases) -> list:
    """For each (cfg, batch, seed) of ``cases``: one training step of
    ``cfg`` (weights ``seed``) in two gloo ranks on the card at B=1 each
    against one process at B=2 on ``batch``'s two frames, under the whole
    ``step_compare`` comparison (loss terms, gradients, updated parameters,
    BN statistics), the tensors whose sensitivity (``DDP_PROBES`` probes)
    passes ``SENS_CAP`` named and exempted, their errors reported. The
    ranks bit-equal, each rank's launches those of a gather step. Every
    case's ranks run in one spawn of the two processes."""
    refs = []
    for cfg, batch, seed in cases:
        (ref,), lr, _, ref_ms = train_steps(None, cfg, batch, 1, seed)
        probes = [train_steps(None, cfg, batch, 1, seed, perturb_seed=s)[0][0]["grads"]
                  for s in range(1, DDP_PROBES + 1)]
        refs.append((ref, lr, ref_ms, sensitivity(ref["grads"], probes)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ranks = spawn.spawn_ranks(train_step_cases, RANKS, cases, device="cuda:0", backend="gloo")
    out = []
    for i, (ref, lr, ref_ms, sens) in enumerate(refs):
        runs = [r[i] for r in ranks]
        got = runs[0][0][0]
        if _record_diff(got, runs[1][0][0]) != 0.0:
            raise AssertionError("the two ranks' steps differ")
        for r, (_, _, launches, _) in enumerate(runs):
            if launches != per_frames(GATHER_STEP, 1):
                raise AssertionError(f"rank {r}: launches {launches}, want "
                                     f"{per_frames(GATHER_STEP, 1)}")
        exempt = over_cap(ref["grads"], sens)
        report = compare_steps(ref, got, sens, lr, exempt=exempt)
        exempt_err = {k: float((got["grads"][k] - ref["grads"][k]).abs().max())
                      / float(ref["grads"][k].abs().max()) for k in exempt}
        out.append({**report, "exempt_err_over_max": exempt_err, "tensors": len(ref["grads"]),
                    "single_b2_ms": ref_ms, "rank_ms": [r[3] for r in runs],
                    "loss_single": float(ref["tb"]["loss"]),
                    "loss_ranks": float(got["tb"]["loss"]),
                    "launches": {k: sum(r[2][k] for r in runs) for k in library.launches}})
    return out


def ddp_conditioning(dev, seeds=range(8), tiny: bool = False):
    """The conditioning of ``phase_ddp``'s one-process B=2 step (f32, full
    width; with ``tiny``, the TINY model's) for each weight seed: per seed,
    the largest sensitivity over a tensor's largest gradient
    (``step_compare.sensitivity``, two probes), the tensors over
    ``step_compare.SENS_CAP`` and the five worst, printed as one JSON line.
    ``DDP_SEED`` and ``DDP_TINY_SEED`` come from it.

        python3 -c "import torch, chip_smoke as c; c.ddp_conditioning(torch.device('cuda', 0))"
    """
    if tiny:
        cfg, batch = TINY, tiny_batch(RANKS)
    else:
        cfg = dataclasses.replace(model_config_from_yaml(load_config(VOD_YAML)),
                                  compute_dtype="float32")
        batch = flagship_batch(cfg, b=RANKS)
    out = {}
    for seed in seeds:
        (ref,), _, _, _ = train_steps(None, cfg, batch, 1, seed)
        probes = [train_steps(None, cfg, batch, 1, seed, perturb_seed=s)[0][0]["grads"]
                  for s in (1, 2)]
        sens = sensitivity(ref["grads"], probes)
        big = max(float(g.abs().max()) for g in ref["grads"].values())
        rows = sorted(((sens[k] / float(g.abs().max()), k) for k, g in ref["grads"].items()
                       if float(g.abs().max()) > ZERO_FLOOR * big), reverse=True)
        out[seed] = {"worst": rows[0][0], "over_cap": sum(r > SENS_CAP for r, _ in rows),
                     "top": rows[:5], "loss": float(ref["tb"]["loss"])}
        print(json.dumps({"seed": seed, **out[seed]}), flush=True)
        torch.cuda.empty_cache()
    return out


def ddp_noise(dev, probes=8, reruns=3, out=None):
    """What separates ``phase_ddp``'s full-width two ranks from one process
    at B=2 (f32, ``DDP_SEED``), tensor by tensor, as a fraction of each
    tensor's largest gradient: the ranks' error; the one-process step's own
    run-to-run change (``reruns`` runs, cuDNN as the phase runs it); its
    sensitivity from probes 1-2 (the phase's) and from 1-``probes``. For
    the tensors the ranks miss by most, how many of their elements are off
    by over ``GRAD_RTOL`` of the largest, for the ranks and for each probe.
    Prints one JSON line (and writes it to ``out``).

        python3 -c "import torch, chip_smoke as c; c.ddp_noise(torch.device('cuda', 0))"
    """
    cfg = dataclasses.replace(model_config_from_yaml(load_config(VOD_YAML)),
                              compute_dtype="float32")
    batch = flagship_batch(cfg, b=RANKS)
    runs = [train_steps(None, cfg, batch, 1, DDP_SEED)[0][0] for _ in range(reruns)]
    ref = runs[0]
    probe = [train_steps(None, cfg, batch, 1, DDP_SEED, perturb_seed=s)[0][0]["grads"]
             for s in range(1, probes + 1)]
    torch.cuda.empty_cache()
    got = spawn.spawn_ranks(train_steps, RANKS, cfg, batch, 1, DDP_SEED, device="cuda:0",
                            backend="gloo")[0][0][0]
    big = max(float(g.abs().max()) for g in ref["grads"].values())
    rows = {}
    for k, g in ref["grads"].items():
        top = float(g.abs().max())
        if top <= ZERO_FLOOR * big:
            continue
        d = [float((p[k] - g).abs().max()) / top for p in probe]
        rows[k] = {"err": float((got["grads"][k] - g).abs().max()) / top,
                   "rerun": max(float((r["grads"][k] - g).abs().max()) for r in runs[1:]) / top,
                   "sens2": max(d[:2]), "sens_all": max(d), "probes": d}
        rows[k]["over_tol2"] = rows[k]["err"] / (GRAD_RTOL + SENS * rows[k]["sens2"])
        rows[k]["over_tol_all"] = rows[k]["err"] / (GRAD_RTOL + SENS * rows[k]["sens_all"])
    worst = sorted(rows, key=lambda k: -rows[k]["over_tol2"])[:6]
    for k in worst:
        g = ref["grads"][k]
        lim = GRAD_RTOL * float(g.abs().max())
        rows[k]["elements"] = g.numel()
        rows[k]["elements_off_ranks"] = int(((got["grads"][k] - g).abs() > lim).sum())
        rows[k]["elements_off_probes"] = [int(((p[k] - g).abs() > lim).sum()) for p in probe]
    result = {
        "seed": DDP_SEED, "probes": probes, "reruns": reruns, "tensors": len(rows),
        "loss_rel": abs(float(got["tb"]["loss"]) / float(ref["tb"]["loss"]) - 1),
        "over_cap2": sorted(k for k, r in rows.items() if r["sens2"] > SENS_CAP),
        "over_cap_all": sorted(k for k, r in rows.items() if r["sens_all"] > SENS_CAP),
        "over_tol2": sorted(k for k, r in rows.items() if r["over_tol2"] > 1),
        "over_tol_all": sorted(k for k, r in rows.items() if r["over_tol_all"] > 1),
        "rerun_max": max(r["rerun"] for r in rows.values()),
        "worst": {k: rows[k] for k in worst}}
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    return result


class _NoUpdate:
    """An optimizer that takes the gradients and changes nothing."""

    def __init__(self, params):
        self.params = params

    def step(self, grads):
        pass


def first_step_terms(dev, weights=None, seeds=(0, 1, 2), frames=6, out=None):
    """The first training step's loss terms of ``configs/hgsfusion_vod.yaml``
    (bf16, as ``tools/train.py`` trains it) on the study's learnable VoD
    tree (``make_study_data``, flagship size, ``frames`` train frames, the
    training augmentation from ``np.random.seed(666)``), one frame a step,
    for the port's init at each of ``seeds`` and for the state_dict file
    ``weights`` (``tests/torch_jax_init.py``: the JAX package's init): per
    init, the terms of each frame and their mean. Prints one JSON line.

        python3 -c "import torch, chip_smoke as c; c.first_step_terms(torch.device('cuda', 0), 'output/jax_vod_init.pt')"
    """
    cfg = load_config(VOD_YAML)
    model_cfg = model_config_from_yaml(cfg)
    inits = {f"port_seed{s}": s for s in seeds}
    if weights:
        inits["jax"] = weights
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        tree = make_study_data.main(["--root", tmp, "--datasets", "vod", "--num_frames",
                                     str(frames + 2), "--val_frames", "2"])["vod"]
        cfg["DATA_CONFIG"]["DATA_PATH"] = str(tree)
        ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=True,
                           logger=create_logger())
        assigner = TargetAssigner(model_cfg.anchor_generator, model_cfg.grid_size,
                                  model_cfg.pc_range, model_cfg.class_names, device=dev)
        for name, w in inits.items():
            model = HGSFusionModel(model_cfg, device=dev, seed=w if isinstance(w, int) else 0)
            if not isinstance(w, int):
                sd = torch.load(w, map_location="cpu")
                model.load_state_dict({k: v.float() if torch.is_floating_point(v) else v
                                       for k, v in sd.items()})
            _, _ = build_optimizer(model_cfg.optimization, TRAIN_TOTAL_STEPS, model)
            params = [p for p in model.parameters() if p.requires_grad]
            step = make_train_step(model, assigner, _NoUpdate(params), model_cfg.loss_weights,
                                   model_cfg)
            np.random.seed(666)
            per = []
            for i in range(frames):
                b = model.batch_to_device(ds.collate_batch([ds[i]]))
                _, tb = step(b)
                per.append({k: float(v) for k, v in tb.items()})
            result[name] = {"mean": {k: float(np.mean([f[k] for f in per])) for k in per[0]},
                            "frames": per}
            del model, step
            torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    return result


def _thr_from_first_frame(model, ds, per_frame: int = 12) -> float:
    """A score threshold that keeps about ``per_frame`` candidates of the
    first frame (random weights score every anchor under 0.1)."""
    with torch.inference_mode():
        preds = model(model.batch_to_device(ds.collate_batch([ds[0]])))
    scores = torch.sigmoid(preds["cls_preds"].float().reshape(-1, model.cfg.num_class))
    top = torch.topk(scores.max(-1).values, per_frame + 1).values.cpu().numpy()
    return float(top[per_frame - 1] + top[per_frame]) / 2


def _small_tree(tmp, yaml_path, frames: int):
    """A ``frames``-frame full-width tree of the config's dataset with its
    infos; returns (cfg, model config, dataset, the --set of its path)."""
    cfg = load_config(yaml_path)
    data = cfg["DATA_CONFIG"]
    root = Path(tmp) / "data"
    data["DATA_PATH"] = str(root)
    write_tree(root, data, frames)
    create_infos(data, cfg["CLASS_NAMES"])
    ds = build_dataset(data, cfg["CLASS_NAMES"], training=False, logger=create_logger())
    return cfg, model_config_from_yaml(cfg), ds, ["DATA_CONFIG.DATA_PATH", str(root)]


def eval_rank(ctx, argv):
    """A rank of ``tools.test.main(argv)``: its result dict, stats and the
    kernel launches it made; TF32 off, as in this script's own process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_launches()
    (result_dict, stats), = test_cli.main(argv).values()
    return {"result": result_dict, "frames": stats["frames"],
            "frames_served": stats["frames_served"], "launches": dict(library.launches)}


EVAL_MULTIPROC_FRAMES = 5  # odd: the second rank's shard ends with frame 0 again
EVAL_VIEWS = {"gather": (VOD_YAML, GATHER_FRAME),
              "polar": ("configs/hgsfusion_vod_polar.yaml", POLAR_FRAME)}


def phase_eval_multiproc(dev):
    """``tools.test.main`` over a 5-frame full-width VoD tree, once in this
    process and once in two gloo ranks on the card (rank 0 writes the merged
    ``result.pkl``), through each view: the merged annotations equal one
    process's bit for bit, and so do the result dicts. The threshold keeps
    about 12 candidates of a frame; both runs compute the same bits on the
    same card, so no score tie falls differently."""
    out = {"launches": {k: 0 for k in library.launches}}
    for view, (yaml_path, per_frame) in EVAL_VIEWS.items():
        with tempfile.TemporaryDirectory() as tmp:
            cfg, model_cfg, ds, data_set = _small_tree(tmp, yaml_path, EVAL_MULTIPROC_FRAMES)
            thr = _thr_from_first_frame(HGSFusionModel(model_cfg, device=dev, seed=0), ds)
            argv = ["--cfg_file", yaml_path, "--set", *data_set,
                    "MODEL.POST_PROCESSING.SCORE_THRESH", str(thr)]
            t0 = time.perf_counter()
            one = eval_rank(None, ["--output_dir", f"{tmp}/one"] + argv)
            one_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ranks = spawn.spawn_ranks(
                eval_rank, RANKS, ["--output_dir", f"{tmp}/two", "--device", "cuda:0"] + argv,
                device="cuda:0", backend="gloo")
            ranks_s = time.perf_counter() - t0
            pkls = {}
            for name in ("one", "two"):
                with open(next(Path(tmp, name).rglob("result.pkl")), "rb") as f:
                    pkls[name] = pickle.load(f)
        differ = [a["frame_id"] for a, b in zip(pkls["two"], pkls["one"])
                  if not annos_equal(a, b)]
        if len(pkls["two"]) != EVAL_MULTIPROC_FRAMES or differ:
            raise AssertionError(f"{view}: the merged result.pkl differs from one process's "
                                 f"in frames {differ} of {[a['frame_id'] for a in pkls['two']]}")
        if not any(len(a["name"]) for a in pkls["one"]):
            raise AssertionError(f"{view}: no frame kept a box")
        for r, got in enumerate(ranks):
            if got["result"] != one["result"]:
                raise AssertionError(f"{view}: rank {r}'s result dict differs")
            want = per_frames(per_frame, 3)
            if got["frames_served"] != 3 or got["launches"] != want:
                raise AssertionError(f"{view}: rank {r} served {got['frames_served']} frames "
                                     f"with launches {got['launches']}, want 3 and {want}")
        for k in out["launches"]:
            out["launches"][k] += sum(r["launches"][k] for r in ranks)
        out[view] = {"frames": EVAL_MULTIPROC_FRAMES, "score_thresh": thr,
                     "boxes": sum(len(a["name"]) for a in pkls["one"]),
                     "headline": one["result"][HEADLINE["VODDataset"]],
                     "one_process_s": one_s, "two_ranks_s": ranks_s,
                     "rank_launches": [r["launches"] for r in ranks]}
    print("  " + json.dumps(out))
    return out


TTA_NUM, TTA_FRAMES = 4, 2


def phase_tta(dev):
    """``tools/test_tta.py`` (``main``) over a 2-frame full-width VoD tree with
    ``--tta_num 4``, through each view: the kernels launched per variant
    (the fused kernel and the NMS, or three forward launches and the NMS),
    every variant's annotations equal to ``serve`` on that variant, one
    annotation and one augmented gt per variant, the VoD result dict."""
    out = {"launches": {k: 0 for k in library.launches}}
    for view, (yaml_path, per_frame) in EVAL_VIEWS.items():
        with tempfile.TemporaryDirectory() as tmp:
            cfg, model_cfg, ds, data_set = _small_tree(tmp, yaml_path, TTA_FRAMES)
            model = HGSFusionModel(model_cfg, device=dev, seed=0)
            thr = _thr_from_first_frame(model, ds)
            model.cfg = dataclasses.replace(model_cfg, score_thresh=thr)
            zero_launches()
            t0 = time.perf_counter()
            det, gt, result, per_variant = test_tta_cli.main(
                ["--cfg_file", yaml_path, "--tta_num", str(TTA_NUM), "--output_dir", tmp,
                 "--set", *data_set, "MODEL.POST_PROCESSING.SCORE_THRESH", str(thr)])
            tool_s = time.perf_counter() - t0
            launches = dict(library.launches)
            want = per_frames(per_frame, TTA_NUM * TTA_FRAMES)
            if launches != want or any(v != per_frames(per_frame, 1) for v in per_variant):
                raise AssertionError(f"{view}: launches {launches}, want {want}")
            if not len(det) == len(gt) == TTA_NUM * TTA_FRAMES:
                raise AssertionError(f"{view}: {len(det)} annotations, {len(gt)} gts")
            for i in range(TTA_FRAMES):
                variants, _ = test_tta_cli.frame_variants(ds, i, TTA_NUM)
                for v, variant in enumerate(variants):
                    batch = ds.collate_batch([variant])
                    ref = ds.generate_prediction_dicts(
                        batch, detections_to_pred_dicts(model.serve(batch)), ds.class_names)[0]
                    if not annos_equal(det[i * TTA_NUM + v], ref):
                        raise AssertionError(f"{view}: frame {i} variant {v} differs from serve")
        if not any(len(a["name"]) for a in det):
            raise AssertionError(f"{view}: no variant kept a box")
        for k in out["launches"]:
            out["launches"][k] += launches[k]
        out[view] = {"variants": len(det), "score_thresh": thr,
                     "boxes": sum(len(a["name"]) for a in det), "tool_s": tool_s,
                     "headline": result[HEADLINE["VODDataset"]], "launches": launches}
    print("  " + json.dumps(out))
    return out


STUDY_FRAMES, STUDY_VAL, STUDY_STEPS = 6, 2, 4


def _logged_launches(log_text: str) -> dict:
    """The last ``kernel launches: {...}`` a CLI logged."""
    lines = [ln for ln in log_text.splitlines() if "kernel launches: " in ln]
    if not lines:
        raise AssertionError("the log names no kernel launches")
    return json.loads(lines[-1].split("kernel launches: ", 1)[1])


def phase_study_small(dev):
    """``study_gpu.sh``'s plumbing at a few frames: ``make_study_data`` (VoD,
    flagship size, 4 train / 2 val frames), 4 training steps of
    ``configs/hgsfusion_vod.yaml`` through ``tools/train.py`` under
    ``torchrun --nproc_per_node 1`` (NCCL, DDP at world size 1), the
    checkpoint evaluated by ``tools/test.py`` through each view, and
    ``study_polar_match`` on the two results."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        trees = make_study_data.main(["--root", tmp, "--datasets", "vod", "--num_frames",
                                      str(STUDY_FRAMES), "--val_frames", str(STUDY_VAL)])
        tree_s = time.perf_counter() - t0
        tree = trees["vod"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "1", "-m", "hgsfusion_tpu_torch.tools.train", "--cfg_file", VOD_YAML, "--epochs",
             "1", "--max_steps", str(STUDY_STEPS), "--workers", "2", "--fix_random_seed",
             "--extra_tag", "study_g", "--output_dir", f"{tmp}/out", "--set",
             "DATA_CONFIG.DATA_PATH", str(tree)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        train_s = time.perf_counter() - t0
        if proc.returncode:
            print(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise AssertionError(f"torchrun training exited {proc.returncode}")
        log = next(Path(tmp, "out").rglob("train.log")).read_text()
        train_launches = _logged_launches(log)
        if train_launches != per_frames(GATHER_STEP, STUDY_STEPS):
            raise AssertionError(f"training launches {train_launches}")
        if "rank 0 of 1 (nccl)" not in log:
            raise AssertionError("the training did not run under a process group")
        ckpt = next(Path(tmp, "out").rglob("ckpt"))
        results, launches = {}, {k: 0 for k in library.launches}
        for view, (yaml_path, per_frame) in EVAL_VIEWS.items():
            zero_launches()
            (result_dict, stats), = test_cli.main(
                ["--cfg_file", yaml_path, "--ckpt_dir", str(ckpt), "--extra_tag", view,
                 "--output_dir", f"{tmp}/eval", "--set", "DATA_CONFIG.DATA_PATH",
                 str(tree)]).values()
            if dict(library.launches) != per_frames(per_frame, STUDY_VAL):
                raise AssertionError(f"{view}: launches {dict(library.launches)}")
            for k in launches:
                launches[k] += library.launches[k]
            results[view] = (result_dict, next(Path(tmp, "eval").rglob(f"{view}/eval/result.pkl")))
        match = study_match.main(["--a", str(results["gather"][1]), "--b",
                                  str(results["polar"][1]), "--infos",
                                  str(tree / "kitti_infos_val.pkl"), "--json", f"{tmp}/m.json"])
        if set(json.loads(Path(tmp, "m.json").read_text())) != {
                "match", "ap_a", "ap_b", "dap", "max_abs_dap"}:
            raise AssertionError("the match report's keys")
    losses = [float(m) for m in re.findall(r"step \d+/\d+ loss ([0-9.]+)", log)]
    out = {"tree_s": tree_s, "train_s": train_s, "losses_logged": losses,
           "train_launches": train_launches,
           "launches": {k: launches[k] + train_launches.get(k, 0) for k in launches},
           "headline": {v: r[0][HEADLINE["VODDataset"]] for v, r in results.items()},
           "max_abs_dap": match["max_abs_dap"]}
    print("  " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# USE_DEPTH: the depth-weighted sampler's kernels and the gather view with the
# DDN depth distribution (hgsfusion_tpu_torch/configs/hgsfusion_vod_depth.yaml)
# ---------------------------------------------------------------------------

DEPTH_YAML = "hgsfusion_tpu_torch/configs/hgsfusion_vod_depth.yaml"
DEPTH_BINS = 80
DEPTH_CHUNK = 256  # entry visits a chunk of the depth backward's phase 2 (csrc CH)
TINY_DEPTH = dataclasses.replace(TINY_XLA, use_depth=True)
# train_cli_depth: each optimizer's run over a small full-width tree, its
# resume by one step and the evaluation of the last run's newest checkpoint
DEPTH_OPTIMIZERS = ("adam_onecycle", "adam", "sgd")
DEPTH_CLI_FRAMES, DEPTH_CLI_STEPS, DEPTH_CLI_EVAL_FRAMES = 4, 2, 2
# the warm-up step's gradients with REMAT on against off: step_compare's
# GRAD_RTOL of a tensor's largest, ZERO_FLOOR of the largest of all where a
# tensor's true gradient is 0; the loss terms of the three steps after it:
# LOSS_AFTER_UPDATE_RTOL, since Adam's per-element normalisation turns
# rounding-level differences of near-zero gradient elements (cuDNN's
# backward sums in no fixed order) into steps of the full learning rate
LOSS_AFTER_UPDATE_RTOL = 1e-2


def depth_config():
    """The depth YAML's model config (bf16, REMAT on)."""
    return model_config_from_yaml(load_config(DEPTH_YAML))


def depth_targets(batch, seed: int = 0):
    """``batch`` with the DDN loss's targets: depth maps at 1/4 of the image
    (1-50 m, their first rows at 0 and last rows at 60 m: out of range) and
    three 2-D boxes in image pixels, padded to 8 rows."""
    rng = np.random.RandomState(seed + 100)
    b, h, w = batch["images"].shape[:3]
    depth = rng.uniform(1.0, 50.0, (b, h // 4, w // 4)).astype(np.float32)
    depth[:, :2], depth[:, -2:] = 0.0, 60.0
    boxes = np.zeros((b, 8, 4), np.float32)
    for i in range(b):
        for j in range(3):
            u1, v1 = rng.uniform(0, 0.7 * w), rng.uniform(0, 0.7 * h)
            boxes[i, j] = [u1, v1, u1 + rng.uniform(0.05, 0.3) * w,
                           v1 + rng.uniform(0.05, 0.3) * h]
    return {**batch, "depth_maps": depth, "gt_boxes2d": boxes}


def bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` of memory traffic and ``ops`` f32
    operations on the card, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes}


def depth_case(name, shape, grid, d, dtype, gen, timed: bool):
    """``quad_sample_depth_fwd`` and ``quad_sample_depth_bwd`` against their
    plain versions on one map (random values), its distribution over ``d``
    bins (a softmax without the overflow bin, in the map's dtype) and
    ``grid`` read in place. Forward: the output at BF16_TOL / F32_TOL, the
    keys bit for bit, the effective weights to 1e-6 of their largest, the
    output without keys and weights bit for bit. Backward: both sum in f32
    in another order, held to F32_TOL (1 + max|ref|) plus the order bound
    n u S (n: an element's terms, S: their magnitudes' sum); two calls bit
    for bit. ``timed``: both kernels' device times (graph replays), the
    plain versions', the bins' and the library's (``F.grid_sample`` 5-D on
    the materialised (B, C, D, H, W) volume, built outside the timing; for
    the backward ``aten.grid_sampler_3d_backward`` plus the contraction over
    C), beside the bounds."""
    b, h, w, c = shape
    dev = grid.device
    f = torch.randn(shape, generator=gen).to(dtype).to(dev)
    probs = torch.softmax(2 * torch.randn(shape[:3] + (d + 1,), generator=gen), -1)[..., :d]
    probs = probs.to(dtype).contiguous().to(dev)
    n = grid[..., 0].numel()
    padded = (b, h + 2, w + 2, c)
    out, key, we = library.quad_sample_depth_fwd(f, probs, grid, taps=True)
    bare = library.quad_sample_depth_fwd(f, probs, grid)[0]
    torch.cuda.synchronize()
    ref, ref_key, ref_we = depth_sample.quad_sample_depth_fwd_plain(f, probs, grid, taps=True)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    dt = str(dtype).replace("torch.", "")
    fwd = {"case": name, "dtype": dt, "shape": list(shape), "depth_bins": d, "queries": n,
           "max_abs_err": float((out.float() - ref.float()).abs().max()), "tol": tol,
           "key_equal": bool(torch.equal(key, ref_key)),
           "we_err_over_max": float((we - ref_we).abs().max())
           / (1 + float(ref_we.abs().max())),
           "bit_equal_without_taps": bool(torch.equal(out, bare))}
    del out, bare, ref, ref_key, ref_we
    ct = torch.randn((n, c), generator=gen).to(dtype).to(dev)
    bins = depth_sample.depth_bins(key, padded)
    got = library.quad_sample_depth_bwd(ct, f, grid, d, bins)
    again = library.quad_sample_depth_bwd(ct, f, grid, d, bins)
    torch.cuda.synchronize()
    want = depth_sample.quad_sample_depth_bwd_plain(ct, f, grid, d)
    s_abs = depth_sample.quad_sample_depth_bwd_plain(ct.float().abs(), f.float().abs(), grid, d)
    counts = (bins[1][1:] - bins[1][:-1]).view(b, h + 2, w + 2)
    per_pixel = (counts[:, 1:-1, 1:-1] + counts[:, 1:-1, :-2] + counts[:, :-2, 1:-1]
                 + counts[:, :-2, :-2])
    n_max = int(per_pixel.max())
    btol = F32_TOL * (1 + float(want.abs().max())) + (n_max + c) * F32_U * s_abs
    diff = (got - want).abs()
    valid = int(bins[1][-1])
    bwd = {"case": name, "dtype": dt, "shape": list(shape), "depth_bins": d, "queries": n,
           "valid_queries": valid, "max_abs_err": float(diff.max()),
           "max_err_over_tol": float((diff / btol).max()), "max_adds_per_pixel": n_max,
           "bit_equal_rerun": bool(torch.equal(got, again))}
    del got, again, want, s_abs, diff, btol
    if timed:
        isz = f.element_size()
        # the grid rows, the map and the distribution once, the output once
        fwd.update(bound(n * 12 + (f.numel() + probs.numel() + n * c) * isz,
                         n * (8.0 * c + 24)))
        fwd["ms"] = graph_ms(lambda: library.quad_sample_depth_fwd(f, probs, grid))
        fwd["taps_ms"] = graph_ms(lambda: library.quad_sample_depth_fwd(f, probs, grid,
                                                                         taps=True))
        fwd["plain_ms"] = cuda_ms(lambda: depth_sample.quad_sample_depth_fwd_plain(
            f, probs, grid), iters=3, warmup=1)
        vol = (f.permute(0, 3, 1, 2)[:, :, None] * probs.permute(0, 3, 1, 2)[:, None]).contiguous()
        g5 = grid.to(dtype)
        fwd["volume_bytes"] = vol.numel() * isz
        fwd["library_ms"] = cuda_ms(lambda: F.grid_sample(
            vol, g5, mode="bilinear", padding_mode="zeros", align_corners=True), iters=5)
        fwd["bound_fraction"] = fwd["bound_ms"] / fwd["ms"]
        # the grid rows, the cotangent, the map, the bins once, the f32
        # gradient once; four dot products of c multiply-adds a valid query
        bwd.update(bound(n * 12 + (n * c + f.numel()) * isz + 4 * (n + b * (h + 2) * (w + 2) + 1)
                         + 4 * b * h * w * d, valid * (8.0 * c + 16)))
        bwd["ms"] = graph_ms(lambda: library.quad_sample_depth_bwd(ct, f, grid, d, bins))
        bwd["visits_per_pixel"] = visit_histogram(per_pixel)
        bwd["bins_ms"] = cuda_ms(lambda: depth_sample.depth_bins(key, padded))
        bwd["plain_ms"] = cuda_ms(lambda: depth_sample.quad_sample_depth_bwd_plain(
            ct, f, grid, d), iters=3, warmup=1)
        g5out = ct.view(grid.shape[:-1] + (c,)).permute(0, 4, 1, 2, 3).contiguous()
        f5 = f.permute(0, 3, 1, 2)[:, :, None]

        def library_bwd():
            gvol = torch.ops.aten.grid_sampler_3d_backward(g5out, vol, g5, 0, 0, True,
                                                           [True, False])[0]
            return (gvol * f5).sum(1)

        bwd["library_ms"] = cuda_ms(library_bwd, iters=3, warmup=1)
        bwd["bound_fraction"] = bwd["bound_ms"] / bwd["ms"]
        del vol, g5out
    print("  fwd " + json.dumps(fwd))
    print("  bwd " + json.dumps(bwd))
    if not fwd["max_abs_err"] <= tol:
        raise AssertionError(f"{name} {dt}: forward max error {fwd['max_abs_err']} > {tol}")
    if not bwd["max_err_over_tol"] <= 1.0:
        raise AssertionError(f"{name} {dt}: backward error {bwd['max_err_over_tol']} x its "
                             f"tolerance")
    for row, k in ((fwd, "key_equal"), (fwd, "bit_equal_without_taps"),
                   (bwd, "bit_equal_rerun")):
        if not row[k]:
            raise AssertionError(f"{name} {dt}: {k} is false")
    if not fwd["we_err_over_max"] <= 1e-6:
        raise AssertionError(f"{name} {dt}: effective weights off by {fwd['we_err_over_max']}")
    return fwd, bwd


def visit_histogram(per_pixel) -> dict:
    """Entry visits per output pixel (the four taps' runs) in powers of two:
    {"<=2^k": pixels}, with the mean and the largest."""
    v = per_pixel.reshape(-1).long()
    edges = [0] + [2 ** k for k in range(14)]
    hist = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        hist[f"{lo + 1 if lo else 0}-{hi}"] = int(((v > lo) & (v <= hi)).sum() + (
            (v == 0).sum() if lo == 0 else 0))
    hist[f">{edges[-1]}"] = int((v > edges[-1]).sum())
    return {"pixels": hist, "mean": float(v.float().mean()), "max": int(v.max())}


def hot_pixel_grid(dev, gen, n: int = 20000):
    """(1, n, 3) grid rows: 90% of the queries on one pixel of a 9x13 map
    (sub-pixel jitter, depth across the bins and beyond), so that the
    pixels of its taps carry far more entries than a chunk of the depth
    backward holds; the rest anywhere on and around the map."""
    g = torch.rand((1, n, 3), generator=gen) * 2.4 - 1.2
    hot = torch.rand(n, generator=gen) < 0.9
    jitter = torch.rand((n, 2), generator=gen) * 0.02
    g[0, hot, 0] = -0.32 + jitter[hot, 0]
    g[0, hot, 1] = 0.11 + jitter[hot, 1]
    return g.to(dev)


def phase_depth_kernels(dev):
    """Both depth kernels at the VoD gather maps (A: 129x484x64, B:
    65x242x192, 80 bins) on the flagship grid read in place, bf16 (timed:
    the backward's kernels split by ``torch.profiler``) and f32, a ragged
    case (two frames, 37 channels, 80 bins, (u, v) and depth beyond the map
    and the bins) and a hot pixel (``hot_pixel_grid``: its taps' pixels
    split into many chunks of the backward's phase 2)."""
    grid = flagship_grid(dev)
    gen = torch.Generator().manual_seed(21)
    fwd, bwd = [], []
    for name, shape in FLAGSHIP_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            f_row, b_row = depth_case(name, shape, grid, DEPTH_BINS, dtype, gen,
                                      timed=dtype == torch.bfloat16)
            fwd.append(f_row)
            bwd.append(b_row)
            torch.cuda.empty_cache()
    ragged = (torch.rand((2, 7, 11, 3, 3), generator=gen) * 2.6 - 1.3).to(dev)
    hot = hot_pixel_grid(dev, gen)
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape, g in (("ragged", (2, 9, 13, 37), ragged), ("hot", (1, 9, 13, 64), hot)):
            f_row, b_row = depth_case(name, shape, g, DEPTH_BINS, dtype, gen, timed=False)
            fwd.append(f_row)
            bwd.append(b_row)
    if not max(r["max_adds_per_pixel"] for r in bwd if r["case"] == "hot") > 4 * DEPTH_CHUNK:
        raise AssertionError("the hot case does not split a pixel into several chunks")
    return {"fwd": fwd, "bwd": bwd}


def phase_serve_depth(dev):
    """The TINY depth model on the card against the CPU (1e-4, the depth
    logits included), then the depth YAML at full width through
    ``serve()``: 2 depth-weighted forward launches and 1 NMS a frame."""
    small = phase_small_reference(dev, TINY_DEPTH, depth_targets(tiny_batch()))
    return {**phase_serve(dev, depth_config(), DEPTH_FRAME), "small_reference": small}


def backbone_retained(model, batch) -> dict:
    """The device memory the backbone leaves allocated when it runs with
    autograd on, against its four taps' own bytes: frozen as training
    freezes it (``build_optimizer``: its parameters do not require grad, nor
    does its input), autograd keeps nothing inside it and REMAT has nothing
    there to recompute; with its parameters trainable, what it would keep."""
    backbone = model.fusion_vfe.image_vfe.ffn.ddn.model.backbone
    x = preprocess_images(model.batch_to_device(batch)["images"])
    out = {}
    for frozen in (True, False):
        backbone.requires_grad_(not frozen)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.enable_grad():
            taps = backbone(x)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        out["frozen" if frozen else "trainable"] = {
            "held_bytes": held, "taps_bytes": sum(t.untyped_storage().nbytes() for t in taps),
            "taps_require_grad": any(t.requires_grad for t in taps)}
        del taps
    return out


def phase_train_depth(dev):
    """The depth YAML at full width, B=1, the DDN term in the loss (targets
    from ``depth_targets``): ``phase_train`` with REMAT on (DEPTH_STEP) and
    off (DEPTH_STEP_NO_REMAT) from the same weights and batch. The warm-up
    step's loss terms equal bit for bit (the same forward) and its
    gradients within GRAD_RTOL; the three timed steps' loss terms within
    LOSS_AFTER_UPDATE_RTOL; each run's step times and peak memory; the
    backbone's retained memory."""
    cfg = depth_config()
    batch = depth_targets(flagship_batch(cfg))
    runs = {}
    for remat in (True, False):
        runs["remat_on" if remat else "remat_off"] = phase_train(
            dev, dataclasses.replace(cfg, remat=remat),
            DEPTH_STEP if remat else DEPTH_STEP_NO_REMAT, batch, keep_grads=True)
        torch.cuda.empty_cache()
    on, off = runs["remat_on"], runs["remat_off"]
    g_on, g_off = on.pop("warmup_grads"), off.pop("warmup_grads")
    big = max(float(g.abs().max()) for g in g_off.values())
    grad_over = 0.0
    for k, g in g_off.items():
        top = float(g.abs().max())
        if top <= ZERO_FLOOR * big:
            grad_over = max(grad_over, float(g_on[k].abs().max()) / (ZERO_FLOOR * big))
        else:
            grad_over = max(grad_over, float((g_on[k] - g).abs().max()) / (GRAD_RTOL * top))
    del g_on, g_off
    model = HGSFusionModel(cfg, device=dev, seed=0).train()
    retained = backbone_retained(model, batch)
    del model
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
              for a, b in zip(on["loss_terms"], off["loss_terms"]) for k in b)
    result = {**runs, "launches": {k: on["launches"][k] + off["launches"][k]
                                   for k in on["launches"]},
              "warmup_loss_bit_equal": on["warmup_loss_terms"] == off["warmup_loss_terms"],
              "warmup_grad_err_over_tol": grad_over, "loss_max_rel_diff": rel,
              "peak_memory_bytes": {"remat_on": on["peak_memory_bytes"],
                                    "remat_off": off["peak_memory_bytes"]},
              "step_ms": {"remat_on": [1e3 * t for t in on["step_s"]],
                          "remat_off": [1e3 * t for t in off["step_s"]]},
              "backbone": retained}
    print("  " + json.dumps({k: result[k] for k in (
        "warmup_loss_bit_equal", "warmup_grad_err_over_tol", "loss_max_rel_diff",
        "peak_memory_bytes", "step_ms", "backbone")}))
    if not result["warmup_loss_bit_equal"]:
        raise AssertionError(f"REMAT changed the first step's loss: {on['warmup_loss_terms']} "
                             f"vs {off['warmup_loss_terms']}")
    if not grad_over <= 1.0:
        raise AssertionError(f"REMAT on and off: first-step gradients {grad_over} x apart")
    if not rel <= LOSS_AFTER_UPDATE_RTOL:
        raise AssertionError(f"REMAT on and off: loss terms {rel} apart")
    if not {"ddn_loss", "fg_loss", "bg_loss"} <= set(on["loss_terms"][0]):
        raise AssertionError(f"no DDN term in the loss: {sorted(on['loss_terms'][0])}")
    frozen = retained["frozen"]
    if frozen["taps_require_grad"] or frozen["held_bytes"] > frozen["taps_bytes"] + 2**20:
        raise AssertionError(f"the frozen backbone retained memory: {retained}")
    return result


def _state_equal(a, b) -> bool:
    """Two optimizer ``state_dict``s (tensors or lists of them) bit for bit."""
    if set(a) != set(b):
        return False
    return all(torch.equal(x.cpu(), y.cpu())
               for k in a for x, y in zip(a[k] if isinstance(a[k], list) else [a[k]],
                                          b[k] if isinstance(b[k], list) else [b[k]]))


def phase_train_cli_depth(dev):
    """The port's ``tools/train.py`` on the depth YAML at full width over a
    4-frame synthetic tree (depth_2 maps read and downsampled by 4), for each
    optimizer: DEPTH_CLI_STEPS steps (DEPTH_STEP launches each, finite
    losses with the DDN term), a resume whose model and optimizer state
    equal the checkpoint bit for bit before it takes one more step; then
    ``tools/test.py --ckpt_dir`` on the last run's newest checkpoint (2
    depth-weighted forward launches and 1 NMS a frame)."""
    cfg = load_config(DEPTH_YAML)
    data = cfg["DATA_CONFIG"]
    failures, runs = [], {}
    launches = {k: 0 for k in library.launches}

    def check(ok, what):
        if not ok:
            failures.append(what)

    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "data", Path(tmp) / "out"
        data["DATA_PATH"] = str(root)
        write_tree(root, data, DEPTH_CLI_FRAMES)
        create_infos(data, cfg["CLASS_NAMES"])
        for name in DEPTH_OPTIMIZERS:
            common = ["--cfg_file", DEPTH_YAML, "--fix_random_seed", "--epochs", "1",
                      "--workers", "2", "--output_dir", str(out), "--extra_tag", name]
            settings = ["--set", "DATA_CONFIG.DATA_PATH", str(root),
                        "OPTIMIZATION.OPTIMIZER", name]
            zero_launches()
            first = train_cli.main(common + ["--max_steps", str(DEPTH_CLI_STEPS)] + settings)
            first_launches = dict(library.launches)
            ckpt = CheckpointManager(Path(first["out_dir"]) / "ckpt")
            run = train_cli.prepare(train_cli.parse_args(common + ["--max_steps", "1"]
                                                         + settings))
            saved = torch.load(ckpt.path(DEPTH_CLI_STEPS), map_location="cpu",
                               weights_only=True)
            restored = (all(torch.equal(v.cpu(), saved["model_state"][k])
                            for k, v in run.model.state_dict().items())
                        and _state_equal(run.optimizer.state_dict(), saved["optimizer_state"]))
            zero_launches()
            second = train_cli.fit(run)
            second_launches = dict(library.launches)
            for k in launches:
                launches[k] += first_launches[k] + second_launches[k]
            check(first_launches == per_frames(DEPTH_STEP, DEPTH_CLI_STEPS),
                  f"{name}: launches {first_launches}")
            check(second_launches == per_frames(DEPTH_STEP, 1),
                  f"{name} resume: launches {second_launches}")
            losses = first["losses"] + second["losses"]
            check(len(losses) == DEPTH_CLI_STEPS + 1 and all(math.isfinite(v) for v in losses),
                  f"{name}: losses {losses}")
            check(restored, f"{name}: the resumed state differs from the checkpoint")
            check(type(run.optimizer).__name__ == ("SGD" if name == "sgd" else "AdamOneCycle"),
                  f"{name}: optimizer {type(run.optimizer).__name__}")
            check(ckpt.all_steps() == [DEPTH_CLI_STEPS, DEPTH_CLI_STEPS + 1],
                  f"{name}: checkpoints {ckpt.all_steps()}")
            runs[name] = {"losses": losses, "restored_bit_equal": restored,
                          "steps_per_s": first["steps_per_s"],
                          "peak_memory_bytes": first["peak_memory_bytes"],
                          "optimizer_state": sorted(saved["optimizer_state"])}
        zero_launches()
        evaluated = test_cli.main(["--cfg_file", DEPTH_YAML, "--ckpt_dir", str(ckpt.ckpt_dir),
                                   "--max_frames", str(DEPTH_CLI_EVAL_FRAMES), "--output_dir",
                                   str(out / "eval"), "--set", "DATA_CONFIG.DATA_PATH",
                                   str(root)])
        eval_launches = dict(library.launches)
    for k in launches:
        launches[k] += eval_launches[k]
    step = DEPTH_CLI_STEPS + 1
    check(sorted(evaluated) == [step], f"evaluated steps {sorted(evaluated)}")
    check(eval_launches == per_frames(DEPTH_FRAME, DEPTH_CLI_EVAL_FRAMES),
          f"eval launches {eval_launches}")
    result_dict, stats = evaluated.get(step, ({}, {}))
    check(stats.get("frames") == DEPTH_CLI_EVAL_FRAMES
          and all(math.isfinite(v) and 0 <= v <= 100 for v in result_dict.values()),
          f"evaluation: {stats.get('frames')} frames, {result_dict}")
    result = {"runs": runs, "launches": launches, "eval_launches": eval_launches,
              "eval_ms_per_frame": stats.get("ms_per_frame")}
    print("  " + json.dumps(result))
    if failures:
        raise AssertionError("; ".join(failures))
    return result


# -- F2V QUANT int8, DDN QUANT w8a8, the occupancy-head variants ---------------
Q8_YAML = "hgsfusion_tpu_torch/configs/hgsfusion_vod_q8.yaml"
W8A8_YAML = "hgsfusion_tpu_torch/configs/hgsfusion_vod_w8a8.yaml"
OCC_V2_YAML = "hgsfusion_tpu_torch/configs/hgsfusion_vod_occ_v2.yaml"
INT8_OPS_PER_S = 1979e12  # dense int8 tensor cores, H100 SXM
BACKBONE_CONVS = 104  # ResNet-101: the stem, 33 x 3 bottleneck convs, 4 downsamples
Q8_FRAME = {library.REDUCE_Q8_KERNEL: 1, **NMS_CALL}
Q8_STEP = {library.Q8_KERNEL: 4, library.BWD_KERNEL: 2, library.BINS: 4}
# every convolution of the backbone quantizes its input once first
W8A8_FRAME = {**Q8_FRAME, library.CONV_W8A8: BACKBONE_CONVS,
              library.QUANTIZE_INT8: BACKBONE_CONVS}
W8A8_POLAR_FRAME = {**POLAR_FRAME, library.CONV_W8A8: BACKBONE_CONVS,
                    library.QUANTIZE_INT8: BACKBONE_CONVS}
Q8_EVAL_FRAMES = 4
TINY_OCC_V2 = dataclasses.replace(TINY_XLA, aspp_dilations=(1, 6, 12, 18),
                                  use_dcn=(False, True, False, False), occ_fuse_mode="SE")


def yaml_config(path, **overrides):
    """A YAML's model config (bf16, REMAT on), with ``overrides``."""
    return dataclasses.replace(model_config_from_yaml(load_config(path)), **overrides)


def bf16_ulp(x):
    """One bf16 unit in the last place of each |x| (0 for 0)."""
    m, e = torch.frexp(x.float().abs())
    return torch.where(m == 0, torch.zeros_like(m), torch.ldexp(torch.ones_like(m), e - 8))


def q8_sample_case(name, features, uv, dtype, timed: bool):
    """``quad_sample_fwd`` on the int8 map (K1-q8, ``quad_sample_q8_fwd``) against
    ``quad_sample_q8_plain`` on ``quantize_per_channel_int8(features)``: both
    sum exact products in f32 in another order and round once, so f32 within
    1e-5 of the taps' magnitude S = sum |w q| (the outputs are unscaled, up to
    127), bf16 within that and one bf16 ulp of each output; idx and w4 bit
    for bit, and without them the same output.
    ``timed``: the kernel (graph replays) beside its bound, the plain version
    and ``F.grid_sample`` on the int8 values in ``dtype``."""
    q, _ = quantize_per_channel_int8(features)
    b, h, w, c = q.shape
    out, idx, w4 = library.quad_sample_fwd(q, uv, taps=True, dtype=dtype)
    bare = library.quad_sample_fwd(q, uv, dtype=dtype)[0]
    torch.cuda.synchronize()
    ref, ref_idx, ref_w4 = quad_sample.quad_sample_q8_plain(q, uv, dtype, taps=True)
    diff = (out.float() - ref.float()).abs()
    # the f32 sums' order: 1e-5 of the taps' magnitude S = sum |w q|
    mag = quad_sample_fwd_plain(F.pad(q.float().abs(), (0, 0, 1, 1, 1, 1)), ref_idx, ref_w4.abs())
    tol = 1e-5 * mag + 1e-30
    if dtype != torch.float32:
        tol += torch.maximum(bf16_ulp(ref), bf16_ulp(out))
    del mag
    n = idx.numel()
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": [b, h, w, c],
           "queries": n, "max_abs_err": float(diff.max()),
           "max_err_over_tol": float((diff / tol).max()),
           "out_dtype": str(out.dtype).replace("torch.", ""),
           "idx_equal": bool(torch.equal(idx, ref_idx)),
           "w4_equal": bool(torch.equal(w4, ref_w4)),
           "bit_equal_without_taps": bool(torch.equal(out, bare))}
    del bare, ref, ref_idx, ref_w4, diff, tol
    if timed:
        isz = out.element_size()
        # each query's (x, y), the int8 map once, the output once
        row.update(bound(n * 8 + q.numel() + n * c * isz, 8.0 * n * c))
        row["bound_taps_ms"] = (row["bytes"] + 20 * n) / HBM_BYTES_PER_S * 1e3
        row["ms"] = graph_ms(lambda: library.quad_sample_fwd(q, uv, dtype=dtype))
        row["taps_ms"] = graph_ms(lambda: library.quad_sample_fwd(q, uv, taps=True, dtype=dtype))
        row["plain_ms"] = cuda_ms(lambda: quad_sample.quad_sample_q8_plain(q, uv, dtype),
                                  iters=3, warmup=1)
        fmap = q.to(dtype).permute(0, 3, 1, 2).contiguous()
        g = uv.reshape(b, -1, uv.shape[-2], 2).to(dtype)
        row["library"] = "F.grid_sample on the int8 values in the compute dtype"
        row["library_ms"] = cuda_ms(lambda: F.grid_sample(
            fmap, g, mode="bilinear", padding_mode="zeros", align_corners=True), iters=50)
        row["bound_fraction"] = row["bound_ms"] / row["ms"]
    print("  " + json.dumps(row))
    if row["out_dtype"] != row["dtype"] or not row["max_err_over_tol"] <= 1.0:
        raise AssertionError(f"{name} {row['dtype']}: max error {row['max_abs_err']} over "
                             f"its tolerance")
    for key in ("idx_equal", "w4_equal", "bit_equal_without_taps"):
        if not row[key]:
            raise AssertionError(f"{name} {row['dtype']}: {key} is false")
    return row


def reduce_q8_case(name, maps, uv, o, dtype, gen, timed: bool):
    """``quad_sample_reduce_q8_fwd`` vs ``quad_sample_reduce_q8_plain`` on
    the int8 quantization of ``maps`` with the scales folded into a random
    reduce kernel, at ``reduce_case``'s tolerances (f32 REDUCE_RTOL x (1 +
    max|ref|); bf16 that plus 2^-5 (S @ |K|) and one bf16 ulp, S the taps'
    magnitude). ``timed``: the kernel beside its bound and the taps' L2
    bytes, the plain version; no single PyTorch call computes the function,
    so ``library_ms`` is null."""
    dev = uv.device
    qs = [quantize_per_channel_int8(m) for m in maps]
    groups = reduce_groups([q for q, _ in qs])
    csum = sum(q.shape[-1] for q, _ in qs)
    kernel = (torch.randn((csum, o), generator=gen) * csum ** -0.5).to(dev)
    kmat = (kernel * torch.cat([s for _, s in qs])[:, None]).to(dtype).contiguous()
    bias = torch.randn(o, generator=gen).to(dev)
    n = uv.numel() // 2
    got = library.quad_sample_reduce_q8_fwd(uv, groups, kmat, bias)
    torch.cuda.synchronize()
    ref = quad_sample.quad_sample_reduce_q8_plain(uv, groups, kmat, bias)
    tol = REDUCE_RTOL[dtype] * (1 + float(ref.float().abs().max()))
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        ratio = float(diff.max()) / tol
    else:
        mag = torch.zeros_like(diff)
        for q, k_off in groups:
            idx, w4 = quad_sample.quad_indices(q, uv, dtype)
            qp = F.pad(q.float().abs(), (0, 0, 1, 1, 1, 1)).contiguous()
            mag.add_(quad_sample_fwd_plain(qp, idx, w4.abs())
                     @ kmat[k_off:k_off + q.shape[-1]].float().abs())
            del qp
        ratio = float((diff / (tol + 2.0 ** -5 * mag + 2.0 ** -7 * ref.float().abs())).max())
        del mag
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "maps": [list(q.shape) for q, _ in qs], "o": o, "queries": n,
           "max_abs_err": float(diff.max()), "max_err_over_tol": ratio,
           "finite": bool(torch.isfinite(got).all()),
           "out_dtype": str(got.dtype).replace("torch.", "")}
    del diff, ref
    if timed:
        isz = kmat.element_size()
        # uv read once, the int8 maps and K once, the output written once
        nbytes = (n * 8 + sum(q.numel() for q, _ in qs) + kmat.numel() * isz + o * 4
                  + n * o * isz)
        ops = 2.0 * n * csum * o
        peak = F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
        row["bytes"], row["ops"] = nbytes, ops
        row["computed_l2_tap_bytes"] = 4 * csum * n  # one byte a channel and tap
        row["ms"] = cuda_ms(lambda: library.quad_sample_reduce_q8_fwd(uv, groups, kmat, bias))
        row["plain_ms"] = cuda_ms(lambda: quad_sample.quad_sample_reduce_q8_plain(
            uv, groups, kmat, bias), iters=3, warmup=1)
        row["library_ms"] = None
        row["bound_fraction"] = row["bound_ms"] / row["ms"]
    print("  " + json.dumps(row))
    if row["out_dtype"] != row["dtype"] or not row["finite"] or not ratio <= 1.0:
        raise AssertionError(f"{name} {row['dtype']}: max error {row['max_abs_err']} over its "
                             f"tolerance")
    return row


def reduce_q8_ragged(dev, dtype):
    """A ragged P3-q8 call from seed 8: two frames of 130 queries (a (2, 10,
    13, 2) view of a grid whose rows hold 3 floats, some coordinates off the
    maps), three int8 groups of 40, 24 and 16 channels (40 and 24 take the
    element path), 72 outputs, K in ``dtype`` with the scales folded in ->
    (uv, groups, kmat, bias)."""
    g = torch.Generator().manual_seed(8)
    grid = (torch.rand((2, 10, 13, 3), generator=g) * 2.6 - 1.3).to(dev)
    groups, scales, off = [], [], 0
    for shape in [(2, 7, 9, 40), (2, 7, 9, 24), (2, 4, 5, 16)]:
        q, s = quantize_per_channel_int8(torch.randn(shape, generator=g).to(dev))
        groups.append((q, off))
        scales.append(s)
        off += shape[-1]
    kernel = (torch.randn((off, 72), generator=g) * off ** -0.5).to(dev)
    kmat = (kernel * torch.cat(scales)[:, None]).to(dtype).contiguous()
    return grid[..., 0:2], groups, kmat, torch.randn(72, generator=g).to(dev)


def output_digest(t) -> str:
    """sha256 of a tensor's bytes (on the CPU), to hold an output bit for bit
    to one recorded from another build."""
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def phase_kernel_vs_plain_q8(dev):
    """F2V QUANT int8's two kernels against their plain versions: K1 on the
    int8 map (``quad_sample_q8_fwd``) at both VoD gather maps on the
    flagship grid's (u, v) read in place, bf16 (timed) and f32, and a ragged
    case (two frames, 37 channels: the element path; coordinates beyond the
    map); P3 on int8 maps (``quad_sample_reduce_q8_fwd``) at both groups in
    one launch, bf16 (timed) and f32, and a ragged case (three groups, odd
    channels and outputs)."""
    gen = torch.Generator().manual_seed(5)
    grid = flagship_grid(dev)
    uv = grid[..., 0:2]
    maps = {k: torch.randn(shape, generator=gen).to(dev) for k, shape in FLAGSHIP_SHAPES.items()}
    fwd = []
    for dtype in (torch.bfloat16, torch.float32):
        for k, f in maps.items():
            fwd.append(q8_sample_case(k, f, uv, dtype, timed=dtype == torch.bfloat16))
    ragged = torch.randn((2, 33, 47, 37), generator=gen).to(dev)
    coords = (torch.rand((2, 450, 2), generator=gen) * 2.6 - 1.3).to(dev)
    fwd.append(q8_sample_case("ragged", ragged, coords, torch.bfloat16, timed=False))
    red = []
    for dtype in (torch.bfloat16, torch.float32):
        red.append(reduce_q8_case("flagship", list(maps.values()), uv, REDUCE_O, dtype, gen,
                                  timed=dtype == torch.bfloat16))
    small = [torch.randn((2, 21, 30, c), generator=gen).to(dev) for c in (40, 24, 56)]
    coords = (torch.rand((2, 111, 2), generator=gen) * 2.4 - 1.2).to(dev)
    red.append(reduce_q8_case("ragged", small, coords, 72, torch.bfloat16, gen, timed=False))
    return {"fwd": fwd, "reduce": red}


def backbone_conv_shapes(cfg):
    """Every convolution of ``cfg``'s image backbone at its image size, as
    {(cin, h, w, cout, k, stride, padding, dilation): count}."""
    with torch.device("meta"):
        bb = ResNetDeepLabBackbone((3, 4, 23, 3) if cfg.image_backbone == "ResNet101"
                                   else (3, 4, 6, 3))
    shapes = {}

    def conv(c, h, w):
        key = (c.in_channels, h, w, c.out_channels, c.kernel_size[0], c.stride[0],
               c.padding[0], c.dilation[0])
        shapes[key] = shapes.get(key, 0) + 1
        k, s, p, d = key[4:]
        return (h + 2 * p - d * (k - 1) - 1) // s + 1, (w + 2 * p - d * (k - 1) - 1) // s + 1

    h, w = conv(bb.conv1, *cfg.image_size)
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # max pool 3/2, padding 1
    for name in ("layer1", "layer2", "layer3", "layer4"):
        for blk in getattr(bb, name):
            conv(blk.conv1, h, w)
            h2, w2 = conv(blk.conv2, h, w)
            conv(blk.conv3, h2, w2)
            if blk.downsample is not None:
                conv(blk.downsample[0], h, w)
            h, w = h2, w2
    return shapes


# the kernel's W8A8 scale in the exactness inputs: amax 127 / 16, so ax =
# 2^-4 exactly and (k + 1/2) 2^-4 are exact rounding midpoints in f32 and bf16
W8A8_AMAX = 127 / 16
W8A8_SUMS = ("ms", "quantize_ms", "quantize_plain_ms", "route_ms", "plain_ms", "library_ms",
             "int_mm_ms", "bound_ms", "bound_int8_ms", "quantize_bound_ms", "ops")
# the ragged cases' outputs: one for each tile width ``library.tile_width`` picks
W8A8_RAGGED_O = (37, 100, 200)


def w8a8_input(shape, gen, dev):
    """A random f32 NHWC activation for ``conv2d_w8a8``: normal values
    (std 2) within W8A8_AMAX, one element at W8A8_AMAX (so its
    ``activation_scale`` is 2^-4), and one in 16 elements on an exact
    rounding midpoint (k + 1/2) 2^-4, k in -127 .. 126: ties to even are
    taken there, in f32 and in bf16."""
    x = (torch.randn(shape, generator=gen) * 2).clamp(-W8A8_AMAX + 0.01, W8A8_AMAX - 0.01)
    mid = torch.rand(shape, generator=gen) < 1 / 16
    k = torch.randint(-127, 127, shape, generator=gen).float()
    x = torch.where(mid, (k + 0.5) / 16, x)
    x.view(-1)[0] = W8A8_AMAX
    return x.to(dev)


def w8a8_activation(shape, gen, dev, stem: bool):
    """A served frame's kind of input for timing: the normalized image's
    normal values at the stem, ReLU outputs (half zeros) elsewhere, bf16."""
    x = torch.randn(shape, generator=gen) * 2
    return (x if stem else torch.relu(x)).to(torch.bfloat16).to(dev)


def parent_activation_scale(x):
    """The activation scale by the formula the int8-input route used before
    ``activation_scale`` (its ``quantize_activation``): the largest |x| in
    x's dtype by ``abs`` and ``amax``, to f32, floored and divided exactly
    by 127."""
    return div_exact(torch.clamp(x.abs().amax().to(torch.float32), min=1e-8),
                     float(conv_int8.QMAX)).reshape(1)


def first_pass(xt, at, wt, args):
    """(wrapper, plain version) of ``conv2d_w8a8``'s first pass on ``xt``
    with scale ``at``: ``quantize_int8`` for channels a multiple of 16, else
    the im2col rows ``im2col_int8`` (the stem)."""
    kp = wt.shape[1]
    if xt.shape[-1] % 16 == 0:
        return (lambda: library.quantize_int8(xt, at)), (lambda: conv_int8.quantize(xt, at))
    return ((lambda: library.im2col_int8(xt, at, *args, kp)),
            (lambda: conv_int8.im2col_plain(conv_int8.quantize(xt, at), *args, kp)))


def w8a8_case(key, count, dev, gen):
    """``conv2d_w8a8`` on a ``w8a8_input`` at one conv shape of the
    backbone, in f32 and bf16 with the input's ``activation_scale``:
    exactly equal to its plain version. On a ``w8a8_activation`` ``xt``
    (bf16, and in f32; its largest |x| not special): ``activation_scale``
    bit for bit the parent's formula (``parent_activation_scale``), the op
    with it equal to the parent's route (that scale, then the int8
    convolution's plain version), and the first pass alone
    (``first_pass``) equal to its plain version. Timed on
    ``xt`` (graph replays): the kernel (``ms``, its first pass included;
    ``quantize_ms`` that pass alone, ``quantize_plain_ms`` its plain
    version), the route (``activation_scale`` + the kernel) beside its
    bound (2 M N K int8 operations, or the bytes of x in bf16, the weights
    and the bf16 output; ``bound_int8_ms`` with x read as int8, the parent
    kernel's input), the plain version, cuDNN's bf16 ``F.conv2d``
    (channels-last) and ``torch._int_mm`` on im2col columns of the quantized
    input built outside the timing, the last two yardsticks only."""
    cin, h, w, cout, k, s, p, d = key
    x = w8a8_input((1, h, w, cin), gen, dev)
    qw = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, dtype=torch.int8).to(dev)
    wt = conv_int8.pack_weight(qw)
    wk = (torch.rand(cout, generator=gen) * 0.01 + 1e-4).to(dev)
    args = ((k, k), (s, s), (p, p), (d, d))
    row = {"shape": list(key), "count": count, "tile_n": library.tile_width(cout)}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        ax = conv_int8.activation_scale(xd)
        ref = conv_int8.conv2d_w8a8_plain(xd, wt, ax, wk, *args, dtype)
        got = library.conv2d_w8a8(xd, wt, ax, wk, *args, dtype)
        name = str(dtype).replace("torch.", "")
        row[f"equal_{name}"] = bool(torch.equal(got, ref))
        row[f"max_abs_err_{name}"] = float((got.float() - ref.float()).abs().max())
    row["scale_is_2^-4"] = bool(float(ax) == 2.0 ** -4)
    del got, ref
    xt = w8a8_activation((1, h, w, cin), gen, dev, stem=cin % 16 != 0)
    at = conv_int8.activation_scale(xt)
    row["scale_equal_parent"] = all(
        torch.equal(conv_int8.activation_scale(v), parent_activation_scale(v))
        for v in (xt, xt.float()))
    # the parent's route on xt: its scale, then the int8 convolution's plain version
    row["equal_parent_route"] = bool(torch.equal(
        library.conv2d_w8a8(xt, wt, at, wk, *args, torch.bfloat16),
        conv_int8.conv2d_w8a8_plain(xt, wt, parent_activation_scale(xt), wk, *args,
                                    torch.bfloat16)))
    run, plain = first_pass(xt, at, wt, args)
    qk, qp = run(), plain()
    row["quantize_equal"] = bool(torch.equal(qk, qp))
    row["quantize_max_abs_err"] = float((qk.int() - qp.int()).abs().max())
    del qk, qp
    ho, wo = (h + 2 * p - d * (k - 1) - 1) // s + 1, (w + 2 * p - d * (k - 1) - 1) // s + 1
    m, kk = ho * wo, k * k * cin
    row["max_abs_err"] = max(row["max_abs_err_float32"], row["max_abs_err_bfloat16"])
    t_ops = 2.0 * m * cout * kk / INT8_OPS_PER_S
    nbytes = 2 * xt.numel() + wt.numel() + 4 * (cout + 1) + 2 * m * cout
    t_bytes = nbytes / HBM_BYTES_PER_S
    # the first pass: x in bf16 read once, its int8 levels (or rows) written once
    q_bytes = 2 * xt.numel() + (xt.numel() if cin % 16 == 0 else m * wt.shape[1])
    row.update(bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_int8_ms=max(t_ops, (nbytes - xt.numel()) / HBM_BYTES_PER_S) * 1e3,
               ops=2.0 * m * cout * kk, bytes=nbytes,
               quantize_bound_ms=q_bytes / HBM_BYTES_PER_S * 1e3)
    row["ms"] = graph_ms(lambda: library.conv2d_w8a8(xt, wt, at, wk, *args, torch.bfloat16),
                         iters=10, replays=2)
    row["quantize_ms"] = graph_ms(run, iters=10, replays=2)
    row["quantize_plain_ms"] = cuda_ms(plain, iters=5)
    row["route_ms"] = graph_ms(lambda: library.conv2d_w8a8(
        xt, wt, conv_int8.activation_scale(xt), wk, *args, torch.bfloat16), iters=10,
        replays=2)
    row["plain_ms"] = cuda_ms(lambda: conv_int8.conv2d_w8a8_plain(
        xt, wt, at, wk, *args, torch.bfloat16), iters=2, warmup=1)
    xb = xt.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
    wb = qw.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    row["library"] = "cuDNN F.conv2d in bf16, channels-last"
    row["library_ms"] = cuda_ms(lambda: F.conv2d(xb, wb, None, s, p, d), iters=10)
    qt = conv_int8.quantize(xt, at)
    cols = F.unfold(qt.permute(0, 3, 1, 2).to(torch.float16), k, dilation=d, padding=p,
                    stride=s)[0].t().to(torch.int8)
    pad = -cols.shape[1] % 8
    cols = F.pad(cols, (0, pad)).contiguous()
    w_cols = F.pad(qw.reshape(cout, -1), (0, pad)).contiguous()
    try:  # a yardstick: cuBLAS's int8 product may refuse a shape
        row["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(cols, w_cols.t()), iters=10)
    except RuntimeError as e:
        row["int_mm_ms"], row["int_mm_error"] = None, str(e)[:200]
    row["bound_fraction"] = row["bound_ms"] / row["ms"]
    del xb, wb, cols, w_cols, qt, xt
    print("  " + json.dumps(row))
    for flag in ("equal_float32", "equal_bfloat16", "scale_is_2^-4", "scale_equal_parent",
                 "equal_parent_route", "quantize_equal"):
        if not row[flag]:
            raise AssertionError(f"conv2d_w8a8 {key}: {flag} is false")
    return row


def phase_kernel_vs_plain_w8a8(dev):
    """``conv2d_w8a8`` exactly equal to its plain version at every distinct
    convolution of the VoD backbone (516 x 1936), each timed, and the sums
    over the backbone's 104 convolutions; then ragged cases at every tile
    width (37, 100 and 200 outputs, ``W8A8_RAGGED_O``): two frames, 48
    channels and 20 (not a multiple of 16: im2col rows), a 3 x 3 kernel at
    stride 2 and dilation 2, random scales, in f32 and bf16, and f32 in
    with a bf16 output; then ``quantize_int8`` alone against
    ``conv_int8.quantize`` in f32, bf16 and f16."""
    cfg = vod_pallas_config()
    shapes = backbone_conv_shapes(cfg)
    if sum(shapes.values()) != BACKBONE_CONVS:
        raise AssertionError(f"{sum(shapes.values())} convolutions, want {BACKBONE_CONVS}")
    gen = torch.Generator().manual_seed(9)
    rows = [w8a8_case(key, count, dev, gen) for key, count in shapes.items()]
    x2 = w8a8_input((2, 19, 23, 48), gen, dev) * 3
    ragged = []
    for cin, x in ((48, x2), (20, x2[..., :20].contiguous())):
        for o in W8A8_RAGGED_O:
            qw = torch.randint(-127, 128, (o, cin, 3, 3), generator=gen, dtype=torch.int8).to(dev)
            wt = conv_int8.pack_weight(qw)
            ax = torch.rand(1, generator=gen).to(dev) * 0.1
            wk = torch.rand(o, generator=gen).to(dev)
            args = ((3, 3), (2, 2), (2, 2), (2, 2))
            for dtype, out_dtype in ((torch.float32,) * 2, (torch.bfloat16,) * 2,
                                     (torch.float32, torch.bfloat16)):
                xd = x.to(dtype)
                got = library.conv2d_w8a8(xd, wt, ax, wk, *args, out_dtype)
                ref = conv_int8.conv2d_w8a8_plain(xd, wt, ax, wk, *args, out_dtype)
                ragged.append({"channels": cin, "o": o, "tile_n": library.tile_width(o),
                               "dtype": str(dtype), "out": str(out_dtype),
                               "equal": bool(torch.equal(got, ref))})
                if not ragged[-1]["equal"]:
                    raise AssertionError(f"conv2d_w8a8 ragged differs from plain: {ragged[-1]}")
    widths = {r["tile_n"] for r in ragged} | {r["tile_n"] for r in rows}
    if widths != {64, 128, 256}:
        raise AssertionError(f"conv2d_w8a8 reached tile widths {sorted(widths)}")
    total = {k: sum(r[k] * r["count"] for r in rows)
             if all(r[k] is not None for r in rows) else None for k in W8A8_SUMS}
    total["bound_by"] = ("operations" if sum(r["count"] * r["bound_ms"] for r in rows
                                             if r["bound_by"] == "operations")
                         >= total["bound_ms"] / 2 else "bytes")
    total["quantize_max_abs_err"] = max(r["quantize_max_abs_err"] for r in rows)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xd = (x2 * 5).to(dtype)
        ax = torch.rand(1, generator=gen).to(dev)
        if not torch.equal(library.quantize_int8(xd, ax), conv_int8.quantize(xd, ax)):
            raise AssertionError(f"quantize_int8 {dtype} differs from its plain version")
    print("  " + json.dumps({"backbone": total, "ragged_cases": len(ragged)}))
    return {"rows": rows, "backbone": total, "ragged": ragged}


def phase_serve_w8a8(dev, view: str):
    """``hgsfusion_vod_w8a8.yaml`` at full width through ``serve()``: in the
    gather view the 104 int8 convolutions, one P3-q8 and one NMS a frame; in
    the polar view (F2V QUANT none, as JAX's polar view refuses it) the 104
    convolutions, 3 forward and one NMS."""
    if view == "polar":
        return phase_serve(dev, yaml_config(W8A8_YAML, f2v_view="polar", f2v_quant="none"),
                           W8A8_POLAR_FRAME)
    return phase_serve(dev, yaml_config(W8A8_YAML), W8A8_FRAME)


def phase_serve_tj4d(dev, view: str, per_frame: dict):
    """A TJ4D config (``view``: pallas or polar) served at 810x1280."""
    cfg = tj4d_config(view)
    return phase_serve(dev, cfg, per_frame, tj4d_serve_batch(cfg))


def phase_serve_occ_v2(dev):
    """The TINY parallel-ASPP model (DCN branch, SE gate) on the card against
    the CPU, then ``hgsfusion_vod_occ_v2.yaml`` at full width through
    ``serve()`` (1 fused, 1 NMS a frame)."""
    small = phase_small_reference(dev, TINY_OCC_V2)
    return {**phase_serve(dev, yaml_config(OCC_V2_YAML), GATHER_FRAME), "small_reference": small}

# ---------------------------------------------------------------------------
# The zoo families: the radar-only detector (configs/radar_pillar_vod.yaml)
# and PointPillars with the multi-head anchor head
# (configs/pp_multihead_nuscenes.yaml), built through build_network
# ---------------------------------------------------------------------------

RADAR_YAML = "configs/radar_pillar_vod.yaml"
PP_YAML = "configs/pp_multihead_nuscenes.yaml"
# the TINY multi-head model: tests/test_torch_pointpillar.py's cut (80 x 80
# pillars, a 40 x 40 head map, 32,000 anchors) on its batch
PP_TINY_RANGE = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
# candidates a set in the TINY multi-head post-processing on the CPU (the
# config's 1,000 run in 4c and at full width)
PP_TINY_PRE_MAX = 200
# the BN biases of the TINY multi-head step, lifted (ReLUs that barely ever
# switch: tests/torch_parity.py::lift_bn_biases)
ZOO_BN_LIFT = 4.0
# the weights of the TINY radar-only step: a seed whose step the CPU's own
# probes find well conditioned (step_compare.SENS_CAP)
RADAR_TINY_SEED = 0
PP_TRAIN_BATCH = 4  # BATCH_SIZE_PER_DEVICE of configs/pp_multihead_nuscenes.yaml
RADAR_CLI_FRAMES, RADAR_CLI_STEPS, RADAR_CLI_EVAL_FRAMES = 8, 6, 4
DEMO_FRAMES = 2


def radar_config():
    """``configs/radar_pillar_vod.yaml``'s model config (f32: it names no
    compute dtype)."""
    return model_config_from_yaml(load_config(RADAR_YAML))


def pp_config(pc_range=None):
    """``configs/pp_multihead_nuscenes.yaml``'s model config, its range
    ``pc_range`` where given."""
    cfg = load_config(PP_YAML)
    if pc_range is not None:
        cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"] = list(pc_range)
    return model_config_from_yaml(cfg)


def radar_batch(cfg, b: int = 1, seed: int = 0):
    """``flagship_batch`` without its image and calibration: a radar-only
    batch (8,192 points x 17 features, gt boxes)."""
    fb = flagship_batch(cfg, b=b, seed=seed)
    return {k: fb[k] for k in ("points", "points_valid", "gt_boxes")}


def tiny_zoo(family: str):
    """(config, batch, seed, BN lift) of a family's small reference."""
    if family == "RadarOnly":
        return TINY, {k: v for k, v in tiny_batch().items() if k != "images"}, \
            RADAR_TINY_SEED, 0.0
    cfg = dataclasses.replace(pp_config(PP_TINY_RANGE), nms_pre_max_size=PP_TINY_PRE_MAX)
    return cfg, nuscenes_batch(cfg, b=2, max_points=2048, max_boxes=24, boxes_per_frame=20,
                               seed=3), 0, ZOO_BN_LIFT


def zoo_model(family: str, cfg, device, seed: int, lift: float = 0.0):
    """``build_network`` of the family, every BN bias raised by ``lift``."""
    model = build_network(family, cfg, device=device, seed=seed)
    if lift:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (torch.nn.BatchNorm2d, MaskedBatchNorm)):
                    m.bias.add_(lift)
    return model


def _listed(preds):
    """Head outputs as (key, index, tensor), a multi-head model's lists
    flattened."""
    return [(k, i, t) for k, v in preds.items()
            for i, t in enumerate(v if isinstance(v, list) else [v])]


def multihead_nms_case(cfg, cpu_model, gpu_model, ref, on_card) -> int:
    """The multi-head post-processing on the card against the CPU: each
    (head, class) set's decoded boxes within 1e-4, then the sets' top
    candidates (the CPU's decode) through the NMS op on both devices: the
    card's keep decisions held to the greedy rule with the CPU's IoU
    (``check_nms_frame``: a decision may differ from the CPU's only at an
    IoU within NMS_TIE of the threshold), then ``post_process`` on the card
    whole. Returns the CPU's kept count."""
    sets = multihead_candidate_sets(ref, cpu_model.anchors, cpu_model.box_coder, cfg)
    card_sets = multihead_candidate_sets(on_card, gpu_model.anchors, gpu_model.box_coder, cfg)
    for b_cpu, b_card in zip(sets[1], card_sets[1]):
        torch.testing.assert_close(b_card.cpu(), b_cpu, rtol=1e-4, atol=1e-4)
    tops = [nms._select(s, b[..., :7], cfg.score_thresh, min(cfg.nms_pre_max_size, s.shape[-1]))
            for s, b in zip(sets[0], sets[1])]
    scores = torch.cat([t[0] for t in tops])
    boxes = torch.cat([t[2] for t in tops]).float().contiguous()
    valid = scores > nms.NEG_INF / 2
    keep_cpu = nms.nms_lazy_op(boxes, valid, cfg.nms_thresh, cfg.nms_post_max_size)
    keep_card = nms.nms_lazy_op(boxes.to(on_card["box_preds"][0].device), valid.to(
        on_card["box_preds"][0].device), cfg.nms_thresh, cfg.nms_post_max_size).cpu()
    ties = sum(check_nms_frame(b, v, k, cfg.nms_thresh, cfg.nms_post_max_size)["tie_decisions"]
               for b, v, k in zip(boxes, valid, keep_card))
    if not torch.equal(keep_card, keep_cpu) and not ties:
        raise AssertionError("the card's NMS kept other candidates than the CPU's")
    got = gpu_model.post_process(on_card)
    if got["valid"].shape[1] != cfg.nms_post_max_size * cfg.num_class or not bool(
            torch.isfinite(got["boxes"][got["valid"]]).all()):
        raise AssertionError(f"the card's detections {got['boxes'].shape}")
    print(f"  multi-head NMS: {boxes.shape[0]} sets, {int(keep_cpu.sum())} kept on the CPU, "
          f"{int((keep_card != keep_cpu).sum())} decisions differ on the card, {ties} at a tie")
    return int(keep_cpu.sum())


def run_zoo_step(family, cfg, device, batch, seed: int, lift: float, perturb_seed=None):
    """One training step of the family's model (``make_train_step_for_cfg``)
    on ``device``: ``step_record`` and the step's learning rate."""
    model = zoo_model(family, cfg, device, seed, lift)
    opt, lr_schedule = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, model)
    cap = GradCapture(opt)
    _, step = make_train_step_for_cfg(model, cap, cfg)
    b = model.batch_to_device(batch)
    if perturb_seed is not None:
        b = perturb_inputs(b, perturb_seed)
    _, tb = step(b)
    return step_record(model, cap, tb), float(lr_schedule(0))


def phase_small_reference_zoo(dev, family: str):
    """A TINY zoo model card vs CPU, one set of weights: the head outputs
    within 1e-4, the post-processing on tie-broken scores (the kept sets
    equal, boxes within 1e-5), one training step under ``step_compare``."""
    cfg, batch, seed, lift = tiny_zoo(family)
    cpu_model = zoo_model(family, cfg, "cpu", seed, lift)
    gpu_model = zoo_model(family, cfg, dev, seed, lift)
    with torch.inference_mode():
        ref = cpu_model(cpu_model.batch_to_device(batch))
        got = gpu_model(gpu_model.batch_to_device(batch))
        errs = {f"{k}{i}": float((g.cpu() - r).abs().max())
                for (k, i, r), (_, _, g) in zip(_listed(ref), _listed(got))}
        print("  head max abs err vs CPU: " + json.dumps(errs))
        for (k, i, r), (_, _, g) in zip(_listed(ref), _listed(got)):
            torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-4)

        # equal scores of identical regions order differently in each
        # device's topk: break the ties first
        def untied(c):
            return c + torch.linspace(0, 0.1, c.numel()).view(c.shape)

        cls = ref["cls_preds"]
        ref = {**ref, "cls_preds": [untied(c) for c in cls] if isinstance(cls, list)
               else untied(cls)}
        on_card = {k: [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)
                   for k, v in ref.items()}
        if family == "RadarOnly":
            kw = dict(score_thresh=0.0, nms_thresh=0.01, pre_max_size=512, post_max_size=100)
            d_ref = post_process(ref, cpu_model.anchors, cpu_model.box_coder, cfg, **kw)
            d_got = post_process(on_card, gpu_model.anchors, gpu_model.box_coder, cfg, **kw)
            if not torch.equal(d_got["valid"].cpu(), d_ref["valid"]):
                raise AssertionError("the card kept other candidates than the CPU")
            v = d_ref["valid"]
            torch.testing.assert_close(d_got["boxes"].cpu()[v], d_ref["boxes"][v],
                                       rtol=1e-5, atol=1e-5)
            kept = int(v.sum())
        else:
            kept = multihead_nms_case(cfg, cpu_model, gpu_model, ref, on_card)
        print(f"  post-process: {kept} boxes kept on the CPU")
    ref_step, lr = run_zoo_step(family, cfg, "cpu", batch, seed, lift)
    probes = [run_zoo_step(family, cfg, "cpu", batch, seed, lift, perturb_seed=s)[0]["grads"]
              for s in (1, 2)]
    got_step, _ = run_zoo_step(family, cfg, dev, batch, seed, lift)
    report = compare_steps(ref_step, got_step, sensitivity(ref_step["grads"], probes), lr)
    report["loss_terms_cpu"] = {k: float(v) for k, v in ref_step["tb"].items()}
    report["loss_terms_card"] = {k: float(v) for k, v in got_step["tb"].items()}
    print("  " + json.dumps(report))
    return {"head_errs": errs, "kept": kept, "train": report}


def scatter_max_case(model, batch, dev) -> dict:
    """The pillar scatter-max (``ops/voxelize.py``, PyTorch's
    ``scatter_reduce``) at the batch's points and the reader's width:
    timed beside its bytes (the rows and their ids read, the grid written)
    and the whole reader's time."""
    reader = model.pillar_net if hasattr(model, "pillar_net") else model.radar_backbone.reader
    b = model.batch_to_device(batch)
    ny, nx = reader.grid_shape
    pc_min = torch.tensor(reader.pc_range[:3], device=dev)
    ids, _ = points_to_pillar_ids(b["points"][..., :3] - pc_min, b["points_valid"],
                                  reader.pillar_size, nx, ny)
    width = reader.pfn_layers.shared_mlps[0].out_features
    rows = torch.rand(ids.shape + (width,), device=dev)
    with torch.inference_mode():
        ms = cuda_ms(lambda: scatter_max_dense(rows, ids, ny * nx), iters=10, warmup=2)
        reader_ms = cuda_ms(lambda: reader(b["points"], b["points_valid"]), iters=10, warmup=2)
    nbytes = rows.numel() * 4 + ids.numel() * ids.element_size() \
        + ids.shape[0] * ny * nx * width * 4
    return {"points": int(ids.numel()), "pillars": ny * nx, "width": width,
            "occupied": int(torch.unique(ids[b["points_valid"]]).numel()),
            "scatter_max_ms": ms, "scatter_max_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "reader_ms": reader_ms}


def profiled_top(fn, top: int = 10, match=()) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its kernels' own device
    time summed, the ``top`` kernels by that time (name, ms, calls), and the
    device ms of the kernels whose names hold each string of ``match``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(((e.key, getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)) / 1e3, e.count)
                  for e in prof.key_averages()), key=lambda r: -r[1])
    return {"device_ms": sum(ms for _, ms, _ in ops),
            "top": [{"op": k[:90], "device_ms": ms, "calls": n} for k, ms, n in ops[:top]],
            "matched_ms": {m: sum(ms for k, ms, _ in ops if m in k) for m in match}}


def profiled_device_ms(fn) -> float:
    """The device time of one call of ``fn`` under ``torch.profiler``: its
    kernels' own time summed (the stream's idle gaps left out)."""
    return profiled_top(fn, top=0)["device_ms"]


def phase_serve_zoo(dev, family: str, cfg, batch, frames: int = 3):
    """A zoo config at full width through ``serve()`` after a warm-up: the
    frames' launches (one NMS a batch, no other kernel), each frame's stream
    ms (CUDA events around it, the host's gaps included) and wall ms, one
    profiled frame's device time, peak memory, the detections' shape; the
    pillar scatter-max timed."""
    model = build_network(family, cfg, device=dev, seed=0)
    model.serve(batch)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    device_ms, wall = [], []
    for _ in range(frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dets = model.serve(batch)
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    launches = dict(library.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = per_frames(NMS_CALL, frames)
    if launches != want:
        raise AssertionError(f"launches in {frames} frames {launches}, want {want}")
    rows = dets["valid"].shape[1]
    want_rows = (cfg.nms_post_max_size * cfg.num_class if family == "PointPillar"
                 else cfg.nms_post_max_size)
    if rows != want_rows or dets["boxes"].shape != (1, rows, 7):
        raise AssertionError(f"detections {dets['boxes'].shape}, want {want_rows} rows")
    if not bool(torch.isfinite(dets["boxes"][dets["valid"]]).all()):
        raise AssertionError("non-finite detections")
    result = {"frames": frames, "launches": launches, "frame_stream_ms": device_ms,
              "frame_wall_ms": wall, "profiled_frame_device_ms": profiled_device_ms(
                  lambda: model.serve(batch)), "peak_memory_bytes": peak,
              "valid_boxes": int(dets["valid"].sum()), "anchors": int(model.anchors.shape[0]),
              **scatter_max_case(model, batch, dev)}
    print("  " + json.dumps(result))
    return result


def conv3d_taps(model) -> int:
    """The weight-gradient products of a training step's 3-D convolutions:
    one per kernel tap of each (``voxel_backbone._Conv3dNDHWC``)."""
    return sum(int(np.prod(m.weight.shape[1:4])) for m in model.modules()
               if isinstance(m, SparseConv3d))


def phase_train_zoo(dev, family: str, cfg, batch, steps: int = 3, per_step=None):
    """A zoo config's training step at full width (``make_train_step_for_cfg``)
    after a warm-up: the kernels ``per_step`` names launched that often a
    step (by default none), finite losses, a positive anchor
    (where the family has anchors), every trainable tensor with a gradient
    moved, no host sync in a step; each step's stream ms (CUDA events), one
    profiled step's device time and top kernels, peak memory, the 3-D
    convolutions' tap products a step (``conv3d_taps``)."""
    model = build_network(family, cfg, device=dev, seed=0)
    opt, _ = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, model)
    cap = GradCapture(opt)
    assigner, step = make_train_step_for_cfg(model, cap, cfg)
    b = model.batch_to_device(batch)
    positives = None
    if assigner is not None:
        positives = int((assigner(b["gt_boxes"])["box_cls_labels"] > 0).sum())
        if positives == 0:
            raise AssertionError("no anchor is positive for the synthetic gt boxes")
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    _, warm = step(b)
    moving = {k for k, g in zip(params, cap.grads) if g is not None and bool(g.any())}
    cap.grads = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    device_ms, terms = [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, tb = step(b)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
        terms.append({k: float(v) for k, v in tb.items()})
    launches = dict(library.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != per_frames(per_step or {}, steps):
        raise AssertionError(f"launches in {steps} steps {launches}, want "
                             f"{per_frames(per_step or {}, steps)}")
    if not all(math.isfinite(v) for t in terms for v in t.values()):
        raise AssertionError(f"non-finite loss terms {terms}")
    params = dict(model.named_parameters())
    still = sorted(k for k in moving if torch.equal(params[k], before[k]))
    if still:
        raise AssertionError(f"trainable tensors that did not move: {still}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({f"{w.filename}:{w.lineno}" for w in caught
                    if "called a synchronizing CUDA operation" in str(w.message)})
    if syncs:
        raise AssertionError(f"the training step made the host wait for the device at {syncs}")
    # the grouped features' gather backward (a sort-based index_put)
    profiled = profiled_top(lambda: step(b), match=("indexing_backward",))
    parta2 = parta2_train_ms(model, b) if isinstance(model, PartA2Model) else None
    result = {"steps": steps, "batch": int(b["points"].shape[0]), "launches": launches,
              "step_stream_ms": device_ms, "profiled_step_device_ms": profiled["device_ms"],
              "profiled_step_top": profiled["top"], "peak_memory_bytes": peak,
              "profiled_step_gather_backward_ms": profiled["matched_ms"]["indexing_backward"],
              "positive_anchors": positives, "loss_terms": terms,
              "warmup_loss_terms": {k: float(v) for k, v in warm.items()},
              "conv3d_tap_products": conv3d_taps(model), "trainable_tensors": len(before),
              "moved": len(moving)}
    if parta2 is not None:
        result["parta2"] = parta2
    print("  " + json.dumps(result))
    return result


def phase_train_cli_radar(dev):
    """``configs/radar_pillar_vod.yaml`` through the CLIs at full width:
    ``tools/train.py`` over an 8-frame tree (no image in its batches, no
    kernel launched), ``tools/test.py --ckpt_dir`` (one NMS a frame), then
    the checkpoint exported at a tie-free threshold and left, with the eval
    frames and ``serve``'s detections of them, for ``phase_serving_host``
    (as ``export_radar``): its detections must equal ``serve``'s."""
    cfg = load_config(RADAR_YAML)
    data = cfg["DATA_CONFIG"]
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "data", Path(tmp) / "out"
        data["DATA_PATH"] = str(root)
        write_tree(root, data, RADAR_CLI_FRAMES)
        create_infos(data, cfg["CLASS_NAMES"])
        data_set = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
        zero_launches()
        trained = train_cli.main(["--cfg_file", RADAR_YAML, "--epochs", "1", "--workers", "2",
                                  "--max_steps", str(RADAR_CLI_STEPS), "--output_dir", str(out)]
                                 + data_set)
        train_launches = dict(library.launches)
        ckpt = CheckpointManager(Path(trained["out_dir"]) / "ckpt")
        zero_launches()
        evaluated = test_cli.main(["--cfg_file", RADAR_YAML, "--ckpt_dir", str(ckpt.ckpt_dir),
                                   "--max_frames", str(RADAR_CLI_EVAL_FRAMES), "--output_dir",
                                   str(out / "eval")] + data_set)
        eval_launches = dict(library.launches)
        (result_dict, stats), = evaluated.values()
        model = build_network(cfg, device=dev, seed=0)
        model.load_state_dict(torch.load(ckpt.path(ckpt.latest_step()), map_location=dev,
                                         weights_only=True)["model_state"])
        ds = build_dataset(data, cfg["CLASS_NAMES"], training=False)
        frames = [ds.collate_batch([ds[i]]) for i in range(RADAR_CLI_EVAL_FRAMES)]
        if any("images" in f for f in frames):
            raise AssertionError("a radar-only batch carries an image")
        # the serving host keeps PyTorch's defaults, cuDNN's TF32 among them,
        # and this f32 config's convolutions take it: serve so here too
        torch.backends.cudnn.allow_tf32 = True
        thr = tie_free_serving_threshold(model, frames)
        model.cfg = dataclasses.replace(model.cfg, score_thresh=thr)
        program, spec = export_cli.export_model(model, frames[0])
        if "images" in spec["inputs"]:
            raise AssertionError(f"the artifact's inputs {sorted(spec['inputs'])}")
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_export_radar_"))
        export_cli.save_artifact(program, spec, work / "model.pt2")
        (work / "in").mkdir()
        for i, f in enumerate(frames):
            np.savez(work / "in" / f"r0_frame{i}.npz",
                     **{k: np.asarray(f[k]) for k in spec["inputs"]})
    refs = [{k: v.cpu().numpy() for k, v in model.serve(f).items()} for f in frames]
    torch.backends.cudnn.allow_tf32 = False
    kept = [int(ref["valid"].sum()) for ref in refs]
    exported = {"inputs": sorted(spec["inputs"]), "kept": kept}
    PENDING_HOST["export_radar"] = (work, per_frames(NMS_CALL, RADAR_CLI_EVAL_FRAMES), refs,
                                    exported)
    checks = {"train": (train_launches, per_frames({}, RADAR_CLI_STEPS)),
              "eval": (eval_launches, per_frames(NMS_CALL, RADAR_CLI_EVAL_FRAMES))}
    for name, (got_l, want_l) in checks.items():
        if got_l != want_l:
            raise AssertionError(f"{name}: launches {got_l}, want {want_l}")
    if trained["steps"] != RADAR_CLI_STEPS or not all(math.isfinite(v) for v in trained["losses"]):
        raise AssertionError(f"training: {trained['steps']} steps, losses {trained['losses']}")
    if stats.get("frames") != RADAR_CLI_EVAL_FRAMES or not all(
            math.isfinite(v) and 0 <= v <= 100 for v in result_dict.values()):
        raise AssertionError(f"evaluation: {stats.get('frames')} frames, {result_dict}")
    result = {"launches": {k: train_launches[k] + eval_launches[k] for k in library.launches},
              "launches_by_run": {k: v[0] for k, v in checks.items()},
              "steps_per_s": trained["steps_per_s"], "losses": trained["losses"],
              "peak_memory_bytes": trained["peak_memory_bytes"],
              "eval_ms_per_frame": stats.get("ms_per_frame"), "eval_result": result_dict,
              "score_thresh": thr, "export": exported}
    HOST_OWNERS["export_radar"] = result
    print("  " + json.dumps(result))
    return result


def phase_demo(dev):
    """``tools/demo.py`` (``main``) on a 2-frame full-width VoD tree with
    the radar-only config and HGSFusion's, ``--html``: each frame served on
    the card (radar: 1 NMS; HGSFusion: 1 fused + 1 NMS), each HTML viewer
    written; the PNGs only where matplotlib is installed (printed)."""
    runs, launches = {}, {k: 0 for k in library.launches}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        cfg = load_config(RADAR_YAML)
        cfg["DATA_CONFIG"]["DATA_PATH"] = str(root)
        write_tree(root, cfg["DATA_CONFIG"], DEMO_FRAMES)
        create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
        for name, yaml_path, per_frame in (("radar", RADAR_YAML, NMS_CALL),
                                           ("hgsfusion", VOD_YAML, GATHER_FRAME)):
            zero_launches()
            out = demo_cli.main(["--cfg_file", yaml_path, "--frames", str(DEMO_FRAMES),
                                 "--out_dir", f"{tmp}/{name}", "--html",
                                 "--set", "DATA_CONFIG.DATA_PATH", str(root)])
            want = per_frames(per_frame, DEMO_FRAMES)
            if dict(library.launches) != want or out["launches"] != want:
                raise AssertionError(f"{name}: launches {dict(library.launches)}, want {want}")
            html = [Path(f).read_text() for f in out["html"]]
            if len(html) != DEMO_FRAMES or not all("pred_boxes" in h for h in html):
                raise AssertionError(f"{name}: HTML files {out['html']}")
            pngs = [Path(f).read_bytes()[:8] for f in out["png"]]
            if out["matplotlib"] and (not pngs or any(h != b"\x89PNG\r\n\x1a\n" for h in pngs)):
                raise AssertionError(f"{name}: PNG files {out['png']}")
            for k in launches:
                launches[k] += library.launches[k]
            runs[name] = {"frames": out["frames"], "html_bytes": [len(h) for h in html],
                          "png": len(out["png"]), "matplotlib": out["matplotlib"]}
    print(f"  PNGs written: {any(r['png'] for r in runs.values())} (matplotlib "
          f"{'installed' if runs['radar']['matplotlib'] else 'not installed'})")
    result = {"launches": launches, "runs": runs}
    print("  " + json.dumps(result))
    return result


# ---- BEVFusion and TransFusion-L ------------------------------------------
BEV_YAML = "configs/bevfusion_vod.yaml"
TF_YAML = "configs/transfusion_vod.yaml"
# launches a served BEVFusion frame (one depth-weighted sample of the FPN's
# reduced map) and a B=1 step with REMAT on (the sample and its bins again
# in the backward; K2 for the map, D2 for the distribution)
BEV_FRAME = {library.DEPTH_KERNEL: 1}
BEV_STEP = {library.DEPTH_KERNEL: 2, library.BINS: 2, library.BWD_KERNEL: 1,
            library.DEPTH_BWD_KERNEL: 1}
BEV_CLI_FRAMES, BEV_CLI_STEPS, BEV_CLI_EVAL_FRAMES = 8, 4, 4
# BEVFusion's level-0 FPN map after channel_reduce (516 x 1936 / 8), its
# bins and the camera grid (nx / 8, ny / 8, nz / 2): 40,000 queries a frame
BEV_MAP = (65, 242, 64)
BEV_BINS = 80
# tests/test_bevfusion.py's TINY BEVFusion with the small Swin, on tiny_batch
TINY_BEV = HGSFusionConfig(
    pc_range=(0.0, -8.0, -3.0, 16.0, 8.0, 2.0), voxel_size=(0.5, 0.5, 0.125), image_size=(64, 96),
    disc_num_bins=16, disc_depth_max=16.0, center_max_k=16, center_feature_map_stride=8,
    image_backbone_arch="swin", swin_embed_dims=16, swin_depths=(2, 2), swin_num_heads=(2, 4),
    swin_window_size=4, swin_mlp_ratio=2, swin_out_indices=(0, 1), fpn_out_channels=24)
QUERY_TIE = 1e-5  # proposal scores closer than this may rank either way


def bevfusion_config():
    """``configs/bevfusion_vod.yaml``'s model config (f32: it names no
    compute dtype)."""
    return model_config_from_yaml(load_config(BEV_YAML))


def transfusion_config():
    return model_config_from_yaml(load_config(TF_YAML))


def bevfusion_grid(dev, b: int = 1):
    """The BEVFusion camera grid (b, 40, 40, 25, 3) of ``flagship_batch``'s
    calibration."""
    cfg = bevfusion_config()
    nx, ny, nz = cfg.grid_size
    batch = flagship_batch(cfg, b=b)
    gen = FrustumGridGenerator((nx // 8, ny // 8, max(nz // 2, 1)), cfg.pc_range, cfg.disc_cfg,
                               cfg.bev_aug)
    return gen(*(torch.from_numpy(batch[k]).to(dev) for k in
                 ("trans_lidar_to_cam", "trans_cam_to_img")), cfg.image_size,
               bda=torch.from_numpy(batch["lidar_aug_matrix"]).to(dev))


def k2_depth_case(name, shape, grid, d, dtype, gen, timed: bool):
    """``quad_sample_bwd`` (K2) on the depth route's effective weights and
    keys (D1's taps) against its plain version: the features' gradient of a
    training step. Tolerances as ``bwd_case``'s; ``timed``: the kernel
    beside its bound, the plain version and the library's pair
    (``aten.grid_sampler_3d_backward`` on the (B, C, D, H, W) volume, then
    the contraction over the bins)."""
    b, h, w, c = shape
    dev = grid.device
    f = torch.randn(shape, generator=gen).to(dtype).to(dev)
    probs = torch.softmax(2 * torch.randn(shape[:3] + (d + 1,), generator=gen), -1)[..., :d]
    probs = probs.to(dtype).contiguous().to(dev)
    padded = (b, h + 2, w + 2, c)
    _, key, we = library.quad_sample_depth_fwd(f, probs, grid, taps=True)
    n = key.numel()
    bins = depth_sample.depth_bins(key, padded)
    g = torch.randn((n, c), generator=gen).to(dtype).to(dev)
    got = library.quad_sample_bwd(g, key, we, padded, bins)
    torch.cuda.synchronize()
    idx = torch.where(key < b * (h + 2) * (w + 2), key, torch.zeros_like(key))
    ref = quad_sample_bwd_plain(g, idx, we, padded)
    diff = (got.float() - ref.float()).abs()
    stats = contention(idx, we, padded)
    if dtype == torch.float32:
        tol = torch.full_like(diff, F32_TOL * (1 + float(ref.abs().max())))
    else:
        s_abs = quad_sample_bwd_plain(g.float().abs(), idx, we.abs(), padded)
        tol = 1e-6 + 2.0 ** -7 * ref.float().abs() + stats["max_adds_per_pixel"] * F32_U * s_abs
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
           "queries": n, "max_abs_err": float(diff.max()),
           "max_err_over_tol": float((diff / tol.clamp(min=1e-30)).max())}
    if timed:
        isz = g.element_size()
        valid = int(bins[1][-1])
        row.update(bound(n * 20 + valid * c * isz + b * h * w * c * isz,
                         2.0 * stats["tap_adds"] * c))
        row["ms"] = graph_ms(lambda: library.quad_sample_bwd(g, key, we, padded, bins))
        row["plain_ms"] = cuda_ms(lambda: quad_sample_bwd_plain(g, idx, we, padded),
                                  iters=3, warmup=1)
        vol = (f.permute(0, 3, 1, 2)[:, :, None] * probs.permute(0, 3, 1, 2)[:, None]).contiguous()
        g5 = grid.to(dtype)
        g5out = g.view(grid.shape[:-1] + (c,)).permute(0, 4, 1, 2, 3).contiguous()
        p5 = probs.permute(0, 3, 1, 2)[:, None]

        def library_bwd():
            gvol = torch.ops.aten.grid_sampler_3d_backward(g5out, vol, g5, 0, 0, True,
                                                           [True, False])[0]
            return (gvol * p5).sum(2)

        row["library_ms"] = cuda_ms(library_bwd, iters=3, warmup=1)
        row["bound_fraction"] = row["bound_ms"] / row["ms"]
        del vol, g5out
    print("  k2 " + json.dumps(row))
    if not bool((diff <= tol).all()):
        raise AssertionError(f"{name} {row['dtype']}: K2 max error {row['max_abs_err']} over "
                             "its tolerance")
    return row


def phase_depth_kernels_bevfusion(dev):
    """D1, D2 and K2 against their plain versions at BEVFusion's shapes: the
    level-0 map 65 x 242 x 64, 80 bins, the camera grid (B, 40, 40, 25, 3)
    read in place; B=1 timed (f32, the config's dtype, and bf16) and B=2
    (f32, bf16), the bins' 16-bit keys over two frames."""
    gen = torch.Generator().manual_seed(23)
    rows = {"fwd": [], "bwd": [], "k2": []}
    for b in (1, 2):
        grid = bevfusion_grid(dev, b)
        for dtype in (torch.float32, torch.bfloat16):
            f_row, b_row = depth_case(f"bevfusion_b{b}", (b,) + BEV_MAP, grid, BEV_BINS, dtype,
                                      gen, timed=b == 1)
            rows["fwd"].append(f_row)
            rows["bwd"].append(b_row)
            rows["k2"].append(k2_depth_case(f"bevfusion_b{b}", (b,) + BEV_MAP, grid, BEV_BINS,
                                            dtype, gen, timed=b == 1))
            torch.cuda.empty_cache()
    if rows["fwd"][0]["queries"] != 40000:
        raise AssertionError(f"BEVFusion's grid has {rows['fwd'][0]['queries']} queries")
    return rows


def compare_transfusion_heads(ref, got, tol: float = 1e-4) -> dict:
    """TransFusion head outputs of one model on two devices: the dense
    heatmap within ``tol``; the proposals matched by (class, cell), every
    per-query output within ``tol``, and the class and cell equal at every
    rank whose score is not within QUERY_TIE of a neighbour's."""
    got = {k: v.cpu() for k, v in got.items()}
    torch.testing.assert_close(got["dense_heatmap"], ref["dense_heatmap"], rtol=tol, atol=tol)
    errs = {"dense_heatmap": float((got["dense_heatmap"] - ref["dense_heatmap"]).abs().max())}
    tied_ranks = 0
    for b in range(ref["query_labels"].shape[0]):
        s = torch.take_along_dim(ref["query_heatmap_score"][b], ref["query_labels"][b][:, None],
                                 dim=1)[:, 0]
        close = ((s[1:] - s[:-1]).abs() < QUERY_TIE) & (s[1:] > 0)
        tied = torch.zeros_like(s, dtype=torch.bool)
        tied[1:] |= close
        tied[:-1] |= close
        tied_ranks += int(tied.sum())
        for k in ("query_labels", "query_pos"):
            if not torch.equal(got[k][b][~tied], ref[k][b][~tied]):
                raise AssertionError(f"frame {b}: {k} differ at a tie-free rank")
        key = {(int(lab), *map(float, pos)): i for i, (lab, pos) in
               enumerate(zip(ref["query_labels"][b], ref["query_pos"][b]))}
        order = [key[(int(lab), *map(float, pos))]
                 for lab, pos in zip(got["query_labels"][b], got["query_pos"][b])]
        for k in ("heatmap", "center", "height", "dim", "rot", "query_heatmap_score"):
            torch.testing.assert_close(got[k][b], ref[k][b][order], rtol=tol, atol=tol)
            errs[k] = max(errs.get(k, 0.0), float((got[k][b] - ref[k][b][order]).abs().max()))
    return {"max_abs_err": errs, "tied_ranks": tied_ranks}


def phase_small_reference_bevfusion(dev):
    """The TINY BEVFusion (swin) on the card (D1) against the CPU (its plain
    version), one set of weights: heads within 1e-4 after the tie rule
    (``compare_transfusion_heads``), one D1 launch; the detections of the
    CPU's heads through the card's ``post_process`` equal the CPU's."""
    cpu_model = BEVFusionModel(TINY_BEV, device="cpu", seed=5)
    gpu_model = BEVFusionModel(TINY_BEV, device=dev, seed=5)
    batch = tiny_batch()
    zero_launches()
    with torch.inference_mode():
        ref = cpu_model(cpu_model.batch_to_device(batch))
        got = gpu_model(gpu_model.batch_to_device(batch))
        launches = dict(library.launches)
        report = compare_transfusion_heads(ref, got)
        d_ref = cpu_model.post_process(ref)
        d_got = gpu_model.post_process({k: v.to(dev) for k, v in ref.items()})
    if launches != per_frames(BEV_FRAME, 1):
        raise AssertionError(f"launches {launches}, want one D1")
    for k in ("valid", "labels"):
        if not torch.equal(d_got[k].cpu(), d_ref[k]):
            raise AssertionError(f"post_process {k} differ on the card")
    torch.testing.assert_close(d_got["boxes"].cpu(), d_ref["boxes"], rtol=1e-5, atol=1e-5)
    print("  " + json.dumps(report))
    return report


def phase_serve_family(dev, name: str, cfg, batch, per_frame: dict, frames: int = 3,
                       family=None):
    """A zoo config (``bench.ZOO[name]``, or the MODEL.NAME ``family``) at
    full width through ``serve()`` after a warm-up: the frames' launches,
    each frame's stream ms (CUDA events) and wall ms, one profiled frame's
    device time, peak memory, the detections (one per proposal for the
    TransFusion head, else the NMS's ``nms_post_max_size`` slots; finite);
    then, for a ``bench.ZOO`` name, the port's ``bench`` entry point
    (``main(["--<name>"])``, in this process): one JSON line with a
    positive value and its timed calls' launches."""
    model = build_network(family or bench.ZOO[name][1], cfg, device=dev, seed=0)
    model.serve(batch)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    stream_ms, wall = [], []
    for _ in range(frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dets = model.serve(batch)
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        stream_ms.append(start.elapsed_time(end))
    launches = dict(library.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != per_frames(per_frame, frames):
        raise AssertionError(f"launches in {frames} frames {launches}, want "
                             f"{per_frames(per_frame, frames)}")
    rows = (cfg.center_max_k if isinstance(model.dense_head, TransFusionHead)
            else cfg.nms_post_max_size)
    if dets["boxes"].shape != (1, rows, 7) or not bool(
            torch.isfinite(dets["boxes"]).all() and torch.isfinite(dets["scores"]).all()):
        raise AssertionError(f"detections {dets['boxes'].shape}, want {rows} rows, finite")
    profiled = profiled_top(lambda: model.serve(batch))
    stages = None
    if hasattr(model, "pfe"):
        stages = pv_stage_ms(model, model.batch_to_device(batch))
    elif isinstance(model, PartA2Model):
        stages = parta2_stage_ms(model, model.batch_to_device(batch))
    del model
    torch.cuda.empty_cache()
    result = {"frames": frames, "launches": launches, "frame_stream_ms": stream_ms,
              "frame_wall_ms": wall, "profiled_frame_device_ms": profiled["device_ms"],
              "profiled_frame_top": profiled["top"], "peak_memory_bytes": peak,
              "valid_boxes": int(dets["valid"].sum())}
    if stages is not None:
        result["stage_ms"] = stages
    if name not in bench.ZOO:
        print("  " + json.dumps(result))
        return result
    rc, lines, notes = run_bench([f"--{name}"])
    line = json.loads(lines[-1]) if lines else {}
    counted = [json.loads(s[len("# launches "):]) for s in notes if s.startswith("# launches ")]
    if rc != 0 or len(lines) != 1 or not line.get("value", 0) > 0 \
            or line.get("metric") != bench.metric_name(name, 1, False) or len(counted) != 1:
        raise AssertionError(f"bench --{name}: rc {rc}, {lines}, {notes[-20:]}")
    if counted[0]["counts"] != per_frames(per_frame, counted[0]["serve_calls"]):
        raise AssertionError(f"bench --{name}: launches {counted[0]}")
    result.update(launches={k: launches[k] + counted[0]["counts"][k] for k in launches},
                  bench={**line, "stderr": notes})
    print("  " + json.dumps(result))
    return result


def phase_train_bevfusion(dev, steps: int = 3):
    """A B=1 BEVFusion step at full width (``make_train_step_for_cfg``,
    stochastic depth on) after a warm-up: each step's launches (BEV_STEP),
    finite loss terms, every trainable tensor with a gradient moved, the
    host waiting for the device only where the matching costs are read
    (``transfusion_head.solve_assignment``, one read a step); each step's
    stream ms, one profiled step's device time, peak memory."""
    cfg = bevfusion_config()
    model = build_network("BEVFusion", cfg, device=dev, seed=0)
    opt, _ = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, model)
    cap = GradCapture(opt)
    _, step = make_train_step_for_cfg(model, cap, cfg)
    b = model.batch_to_device(flagship_batch(cfg))
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    _, warm = step(b)
    moving = {k for k, g in zip(params, cap.grads) if g is not None and bool(g.any())}
    cap.grads = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    stream_ms, terms = [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, tb = step(b)
        end.record()
        end.synchronize()
        stream_ms.append(start.elapsed_time(end))
        terms.append({k: float(v) for k, v in tb.items()})
    launches = dict(library.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != per_frames(BEV_STEP, steps):
        raise AssertionError(f"launches in {steps} steps {launches}, want "
                             f"{per_frames(BEV_STEP, steps)}")
    if not all(math.isfinite(v) for t in terms for v in t.values()):
        raise AssertionError(f"non-finite loss terms {terms}")
    params = dict(model.named_parameters())
    still = sorted(k for k in moving if torch.equal(params[k], before[k]))
    if still:
        raise AssertionError(f"trainable tensors that did not move: {still}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({f"{w.filename}:{w.lineno}" for w in caught
                    if "called a synchronizing CUDA operation" in str(w.message)})
    if len(syncs) != 1 or not syncs[0].split(":")[0].endswith("transfusion_head.py"):
        raise AssertionError(f"the step made the host wait for the device at {syncs} (one read "
                             "of the matching costs expected)")
    profiled = profiled_top(lambda: step(b))
    result = {"steps": steps, "batch": 1, "launches": launches, "step_stream_ms": stream_ms,
              "profiled_step_device_ms": profiled["device_ms"],
              "profiled_step_top": profiled["top"],
              "peak_memory_bytes": peak, "loss_terms": terms, "host_reads": syncs,
              "warmup_loss_terms": {k: float(v) for k, v in warm.items()},
              "trainable_tensors": len(before), "moved": len(moving)}
    print("  " + json.dumps(result))
    return result


def phase_train_cli_family(dev, yaml_path: str, per_step: dict, per_frame: dict,
                           export_as: str | None = None):
    """A zoo YAML (the TransFusion-head families, CenterPoint, SECOND,
    SECOND-IoU, Voxel R-CNN) through the CLIs at full width:
    ``tools/train.py`` over an 8-frame VoD tree (``per_step`` launches a
    step; BEVFusion: BEV_STEP), then ``tools/test.py --ckpt_dir`` on its
    checkpoint (``per_frame``; BEVFusion: one D1; CenterPoint, SECOND: one
    NMS call; the two-stage families two). With ``export_as``, the
    checkpoint is also exported by ``tools/export.py`` (``main``) and left,
    with the first 3 evaluation frames and ``serve``'s detections of them
    from that checkpoint, for ``phase_serving_host`` under that name."""
    cfg = load_config(yaml_path)
    data = cfg["DATA_CONFIG"]
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "data", Path(tmp) / "out"
        data["DATA_PATH"] = str(root)
        write_tree(root, data, BEV_CLI_FRAMES)
        create_infos(data, cfg["CLASS_NAMES"])
        data_set = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
        zero_launches()
        trained = train_cli.main(["--cfg_file", yaml_path, "--epochs", "1", "--workers", "2",
                                  "--max_steps", str(BEV_CLI_STEPS), "--output_dir", str(out)]
                                 + data_set)
        train_launches = dict(library.launches)
        ckpt = CheckpointManager(Path(trained["out_dir"]) / "ckpt")
        zero_launches()
        evaluated = test_cli.main(["--cfg_file", yaml_path, "--ckpt_dir", str(ckpt.ckpt_dir),
                                   "--max_frames", str(BEV_CLI_EVAL_FRAMES), "--output_dir",
                                   str(out / "eval")] + data_set)
        eval_launches = dict(library.launches)
        exported = None if export_as is None else export_checkpoint(
            dev, export_as, yaml_path, cfg, ckpt.ckpt_dir, per_frame)
    (result_dict, stats), = evaluated.values()
    checks = {"train": (train_launches, per_frames(per_step, BEV_CLI_STEPS)),
              "eval": (eval_launches, per_frames(per_frame, BEV_CLI_EVAL_FRAMES))}
    for name, (got_l, want_l) in checks.items():
        if got_l != want_l:
            raise AssertionError(f"{name}: launches {got_l}, want {want_l}")
    if trained["steps"] != BEV_CLI_STEPS or not all(math.isfinite(v) for v in trained["losses"]):
        raise AssertionError(f"training: {trained['steps']} steps, losses {trained['losses']}")
    if stats.get("frames") != BEV_CLI_EVAL_FRAMES or not all(
            math.isfinite(v) and 0 <= v <= 100 for v in result_dict.values()):
        raise AssertionError(f"evaluation: {stats.get('frames')} frames, {result_dict}")
    result = {"launches": {k: train_launches[k] + eval_launches[k] for k in library.launches},
              "launches_by_run": {k: v[0] for k, v in checks.items()},
              "steps_per_s": trained["steps_per_s"], "losses": trained["losses"],
              "peak_memory_bytes": trained["peak_memory_bytes"],
              "eval_ms_per_frame": stats.get("ms_per_frame"), "eval_result": result_dict}
    if exported is not None:
        result["export"] = exported
        HOST_OWNERS[export_as] = result
    print("  " + json.dumps(result))
    return result


EXPORT_CLI_FRAMES = 3


def export_checkpoint(dev, name: str, yaml_path: str, cfg: dict, ckpt_dir, per_frame: dict):
    """``tools/export.py`` (``main``) on the newest checkpoint of
    ``ckpt_dir``; the first EXPORT_CLI_FRAMES evaluation frames written as
    ``.npz`` files and ``serve``'s detections of them (the checkpoint's
    weights, PyTorch's default TF32 settings, as the serving host keeps
    them; a second call must give the same bits) left for
    ``phase_serving_host`` under ``name``. Returns the
    export's seconds and bytes (the host's numbers join them there)."""
    work = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
    t0 = time.perf_counter()
    spec = export_cli.main(["--cfg_file", yaml_path, "--ckpt_dir", str(ckpt_dir), "--out",
                            str(work / "model.pt2"), "--set", "DATA_CONFIG.DATA_PATH",
                            cfg["DATA_CONFIG"]["DATA_PATH"]])
    export_s = time.perf_counter() - t0
    model = build_network(cfg, device=dev, seed=0)
    ckpt = CheckpointManager(Path(ckpt_dir))
    model.load_state_dict(torch.load(ckpt.path(ckpt.latest_step()), map_location=dev,
                                     weights_only=True)["model_state"])
    ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False)
    frames = [ds.collate_batch([ds[i]]) for i in range(EXPORT_CLI_FRAMES)]
    (work / "in").mkdir()
    for i, f in enumerate(frames):
        np.savez(work / "in" / f"r0_frame{i}.npz",
                 **{k: np.asarray(f[k]) for k in spec["inputs"]})
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        refs = [{k: v.cpu().numpy() for k, v in model.serve(f).items()} for f in frames]
        again = [{k: v.cpu().numpy() for k, v in model.serve(f).items()} for f in frames]
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    if not all(np.array_equal(a[k], r[k]) for a, r in zip(again, refs) for k in r):
        raise AssertionError(f"{name}: serve gave other detections on a second call")
    result = {"export_s": export_s, "artifact_bytes": (work / "model.pt2").stat().st_size,
              "inputs": sorted(spec["inputs"]), "kept": [int(r["valid"].sum()) for r in refs]}
    PENDING_HOST[name] = (work, per_frames(per_frame, EXPORT_CLI_FRAMES), refs, result)
    return result


# ---- CenterPoint, SECOND and VoxelNeXt -----------------------------------
# the VoD configs of the center-head families and SECOND (f32), by the
# ``bench.ZOO`` name of each; the nuScenes CenterPoint served and trained
# on ``nuscenes_batch``
CENTER_ZOO = ("centerpoint", "centerpoint_res2d", "second", "voxelnext", "voxelnext2d")
CP_NUSCENES_YAML = "configs/centerpoint_nuscenes.yaml"
CENTER_TRAIN_BATCH = 4  # BATCH_SIZE_PER_DEVICE of configs/centerpoint_nuscenes.yaml
# the decoded candidates' NMS: VoD 500 at 0.01 (500 kept at most), nuScenes
# 500 at 0.2 (83 kept)
CENTER_K, NUSC_NMS_KEEP = 500, 83
# the TINY cut of each VoD arch (tests/test_torch_center_families.py)
TINY_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 2.0)


def zoo_config(name: str):
    """The model config of ``bench.ZOO[name]``'s YAML (f32)."""
    return model_config_from_yaml(load_config(bench.ZOO[name][0]))


def cp_nuscenes_config():
    return model_config_from_yaml(load_config(CP_NUSCENES_YAML))


def cp_nuscenes_batch(cfg, b: int = 1):
    """``nuscenes_batch`` for the anchor-free CenterPoint config: its boxes
    sized by the multi-head config's anchors (the same ten classes)."""
    return nuscenes_batch(dataclasses.replace(cfg, anchor_generator=pp_config().anchor_generator),
                          b=b)


def tiny_center(name: str):
    """A VoD arch cut to TINY: 0.5 m pillars (CenterPoint, head at stride 2),
    0.25 m (the sparse-pillar archs, stride 8), 0.5 / 0.125 m voxels (SECOND,
    VoxelNeXt: 41 planes), 16 candidates, NMS over all of them, score
    threshold 0 (random weights score near the 0.1 default)."""
    cfg = zoo_config(name)
    voxel = {"centerpoint": (0.5, 0.5, 0.5), "second": (0.5, 0.5, 0.125),
             "voxelnext": (0.5, 0.5, 0.125)}.get(name, (0.25, 0.25, 0.5))
    anchors = tuple(cfg.anchor_generator)
    return dataclasses.replace(cfg, pc_range=TINY_RANGE, voxel_size=voxel, center_max_k=16,
                               nms_pre_max_size=96, nms_post_max_size=16, score_thresh=0.0,
                               center_post_limit=(-5.0, -30.0, -5.0, 55.0, 30.0, 5.0),
                               anchor_generator=anchors)


def tiny_center_batch(cfg):
    """Two frames of 256 points over the TINY range (17 features), two gt
    boxes."""
    rng = np.random.RandomState(0)
    pts = np.zeros((2, 256, cfg.num_point_features), np.float32)
    pts[..., 0] = rng.uniform(0.5, 15, (2, 256))
    pts[..., 1] = rng.uniform(-7, 7, (2, 256))
    pts[..., 2] = rng.uniform(-2.5, 1.5, (2, 256))
    pts[..., 3:] = rng.randn(2, 256, cfg.num_point_features - 3)
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, 0] = [4, -2, -0.5, 3.9, 1.6, 1.56, 0.3, 1]
    return {"points": pts, "points_valid": np.ones((2, 256), bool), "gt_boxes": gt}


def phase_nms_center(dev):
    """``nms_lazy`` against its plain version at the center families'
    shapes: the decode's 500 candidates at 0.01 (500 kept at most) for B=1
    and B=2, and the nuScenes CenterPoint's 500 at 0.2 (83 kept), every
    candidate valid, and a B=1 case with a tenth valid (the decode's
    ``valid``); the keep sets must equal the plain version's."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    vod = t(clustered_boxes(CENTER_K, 100, 7))[None]
    pair = t(np.stack([clustered_boxes(CENTER_K, 100, 8), clustered_boxes(CENTER_K, 200, 9)]))
    ones = torch.ones((1, CENTER_K), dtype=torch.bool, device=dev)
    rows = [
        nms_case("center_vod", vod, ones, NMS_KEEP, timed=True),
        nms_case("center_vod_b2", pair, ones.expand(2, -1).contiguous(), NMS_KEEP, timed=True),
        nms_case("center_vod_tenth", vod, torch.arange(CENTER_K, device=dev)[None] % 10 == 0,
                 NMS_KEEP, timed=False),
        nms_case("center_nuscenes", t(nuscenes_candidate_sets(1, CENTER_K, 10)), ones,
                 NUSC_NMS_KEEP, timed=True, nms_thresh=MH_NMS_THRESH),
    ]
    for r in rows:
        if not r["equal_to_plain"]:
            raise AssertionError(f"{r['case']}: keep sets differ from the plain version's")
    if rows[3]["kept"] != [NUSC_NMS_KEEP]:
        raise AssertionError(f"nuScenes kept {rows[3]['kept']}")
    return rows


def phase_top_scores(dev):
    """``ops.nms.top_scores`` (a stable descending sort, equal scores by
    index, as every detection pre-selection of the port takes it) against
    ``torch.topk`` (ties in no stated order) at the pre-selection shapes:
    the radar-only VoD anchors, SECOND's, the CenterPoint heatmaps (VoD,
    nuScenes) and the NMS's own top ``NMS_PRE_MAXSIZE``: the device ms of
    each; the values must be equal."""
    g = torch.Generator(device="cpu").manual_seed(11)
    rows = []
    for case, b, n, k in (("radar_vod_anchors", 1, 614_400, NMS_K),
                          ("second_anchors", 1, 9_600, NMS_K),
                          ("centerpoint_vod_hm", 1, 76_800, CENTER_K),
                          ("centerpoint_nuscenes_hm", 1, 655_360, CENTER_K),
                          ("centerpoint_vod_hm_b2", 2, 76_800, CENTER_K),
                          ("nms_pre", 1, CENTER_K, CENTER_K)):
        # sigmoid scores quantized so that ties occur, as random weights give
        scores = (torch.rand((b, n), generator=g) * 4096).floor().div(4096).to(dev)
        values, _ = nms.top_scores(scores, k)
        if not torch.equal(values, torch.topk(scores, k, dim=-1).values):
            raise AssertionError(f"{case}: top_scores' values differ from torch.topk's")
        rows.append({"case": case, "batch": b, "n": n, "k": k,
                     "ms": cuda_ms(lambda: nms.top_scores(scores, k), iters=20),
                     "topk_ms": cuda_ms(lambda: torch.topk(scores, k, dim=-1), iters=20)})
    print("  " + json.dumps(rows))
    return rows


def compare_center_detections(d_ref, d_got) -> dict:
    """Detections of one model's post-processing on the CPU and on the card
    from the same (tie-broken) head outputs: valid and labels equal, boxes
    and scores within 1e-5."""
    d_got = {k: v.cpu() for k, v in d_got.items()}
    for k in ("valid", "labels"):
        if not torch.equal(d_got[k], d_ref[k]):
            raise AssertionError(f"the card's post_process {k} differ from the CPU's")
    for k in ("boxes", "scores"):
        torch.testing.assert_close(d_got[k], d_ref[k], rtol=1e-5, atol=1e-5)
    return {"kept": int(d_ref["valid"].sum())}


def phase_small_reference_center(dev):
    """Each VoD arch (CenterPoint classic and res2d, SECOND, VoxelNeXt, and
    VoxelNeXt2D) cut to TINY, card vs CPU, one set of weights: every head
    output within 1e-4; the post-processing (decode and NMS, or SECOND's
    anchors and NMS) of the CPU's heads with a ramp added to the scores
    (the tie rule: random weights leave scores within 1e-6 of each other,
    which the two devices' sigmoids may order apart) on both devices: the
    kept candidates equal; one NMS call each on the card."""
    out = {}
    for name in CENTER_ZOO:
        cfg = tiny_center(name)
        family = bench.ZOO[name][1]
        cpu_model = build_network(family, cfg, device="cpu", seed=3)
        gpu_model = build_network(family, cfg, device=dev, seed=3)
        batch = tiny_center_batch(cfg)
        with torch.inference_mode():
            ref = cpu_model(cpu_model.batch_to_device(batch))
            got = gpu_model(gpu_model.batch_to_device(batch))
            errs = {k: float((got[k].cpu() - r).abs().max()) for k, r in ref.items()}
            for k, r in ref.items():
                torch.testing.assert_close(got[k].cpu(), r, rtol=1e-4, atol=1e-4)
            key = "cls_preds" if name == "second" else "hm"
            ramp = torch.linspace(0, 1.0, ref[key].numel()).view(ref[key].shape)
            ref = {**ref, key: ref[key] + ramp}
            zero_launches()
            d_got = gpu_model.post_process({k: v.to(dev) for k, v in ref.items()})
            launches = dict(library.launches)
            d_ref = cpu_model.post_process(ref)
        if launches != per_frames(NMS_CALL, 1):
            raise AssertionError(f"{name}: launches {launches}, want one NMS call")
        out[name] = {"head_max_abs_err": errs, **compare_center_detections(d_ref, d_got)}
    print("  " + json.dumps(out))
    return out


# ---- the focal SECOND, SECOND-IoU and Voxel R-CNN ---------------------------
# the VoD configs (f32) by their ``bench.ZOO`` names
TWOSTAGE_ZOO = ("second_focal", "second_iou", "voxelrcnn", "pvrcnn", "pvrcnnpp", "parta2")
NMS_TWICE = {library.NMS_MASK: 2, library.NMS_SWEEP: 2}
# NMS calls a served frame (the two-stage families: the proposals' and the
# detections') and a training step (the proposals'); PV-RCNN's and
# PV-RCNN++'s keypoints: one FPS launch a batch, in serving and training
PV_FRAME = {**NMS_TWICE, library.FPS: 1}
PV_STEP = {**NMS_CALL, library.FPS: 1}
TWOSTAGE_FRAME = {"second_focal": NMS_CALL, "second_iou": NMS_TWICE, "voxelrcnn": NMS_TWICE,
                  "pvrcnn": PV_FRAME, "pvrcnnpp": PV_FRAME, "parta2": NMS_TWICE}
TWOSTAGE_STEP = {"second_focal": {}, "second_iou": NMS_CALL, "voxelrcnn": NMS_CALL,
                 "pvrcnn": PV_STEP, "pvrcnnpp": PV_STEP, "parta2": NMS_CALL}
# the proposal layer's NMS (top 512 at ROI_HEAD.NMS_THRESH_TRAIN 0.8, 128
# kept) and SECOND-IoU's final one (its 128 proposals at 0.01, 500 slots)
PROPOSAL_K, PROPOSAL_KEEP, PROPOSAL_THRESH = 512, 128, 0.8
# the weight seed of the TINY cuts; no importance of the focal layers may lie
# within FOCAL_TIE of a k-th one but its exact ties (checked on the CPU)
TWOSTAGE_TINY_SEED, FOCAL_TIE = 3, 1e-6


def phase_nms_twostage(dev):
    """``nms_lazy`` against its plain version at the two-stage shapes: the
    proposals (512 candidates, 0.8, at most 128 kept; B=1 timed, B=2) and
    SECOND-IoU's detections (128 proposals at 0.01, 500 slots): equal keep
    sets."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ones = torch.ones((1, PROPOSAL_K), dtype=torch.bool, device=dev)
    rows = [
        nms_case("proposals", t(clustered_boxes(PROPOSAL_K, 64, 21))[None], ones,
                 PROPOSAL_KEEP, timed=True, nms_thresh=PROPOSAL_THRESH),
        nms_case("proposals_b2", t(np.stack([clustered_boxes(PROPOSAL_K, 64, 22),
                                             clustered_boxes(PROPOSAL_K, 32, 23)])),
                 ones.expand(2, -1).contiguous(), PROPOSAL_KEEP, timed=False,
                 nms_thresh=PROPOSAL_THRESH),
        nms_case("second_iou_final", t(clustered_boxes(PROPOSAL_KEEP, 40, 24))[None],
                 ones[:, :PROPOSAL_KEEP].contiguous(), NMS_KEEP, timed=True),
    ]
    for r in rows:
        if not r["equal_to_plain"]:
            raise AssertionError(f"{r['case']}: keep sets differ from the plain version's")
    if rows[0]["kept"] != [PROPOSAL_KEEP]:
        raise AssertionError(f"proposals kept {rows[0]['kept']}, want the {PROPOSAL_KEEP} cut")
    return rows


def phase_ball_query(dev):
    """Voxel R-CNN's ball query at full width: ``configs/voxelrcnn_vod.yaml``
    on the flagship batch (random weights, seed 0), its 128 proposals'
    27,648 grid points over x_conv2, x_conv3 and x_conv4: the windowed
    query (``ball_query_grid``) timed at every grid point, and its index
    lists and masks equal to the dense form's (``ball_query``) exactly
    where the dense (M, N) matrix fits: one RoI's 216 points at x_conv2,
    4 RoIs' at x_conv3, every point at x_conv4."""
    cfg = zoo_config("voxelrcnn")
    model = build_network("VoxelRCNN", cfg, device=dev, seed=0)
    with torch.inference_mode():
        batch = model.batch_to_device(flagship_batch(cfg))
        x3d, stages, _ = model.voxel_features(batch)
        rois, _, _, _ = model.rpn_proposals(model.dense_head(
            model.backbone_2d(height_compression(x3d))))
        grid = roi_grid_points(rois, 6).reshape(-1, 3)
        rows = []
        for (name, _, _), dense_rois in zip(model.roi_grid_pool.SOURCES, (1, 4, PROPOSAL_KEEP)):
            centers, _, valid, geom = stage_point_set(stages[name], cfg.pc_range,
                                                      cfg.voxel_size)
            radius = getattr(model.roi_grid_pool, f"pool_{name}").radii[0]

            def windowed():
                return ball_query_grid(grid, *geom, valid[0], radius, 16)

            idx, any_nb = windowed()
            n = dense_rois * 216
            ref_idx, ref_any = ball_query(grid[:n], centers, valid[0], radius, 16)
            row = {"stage": name, "cells": int(centers.shape[0]), "active": int(valid.sum()),
                   "centres": int(grid.shape[0]), "radius": radius,
                   "window": [window_span(radius, p) for p in geom[1]],
                   "with_neighbours": int(any_nb.sum()), "ms": cuda_ms(windowed, iters=5),
                   "dense_centres": n, "equal_to_dense": bool(
                       torch.equal(idx[:n], ref_idx) and torch.equal(any_nb[:n], ref_any)),
                   "dense_ms": cuda_ms(lambda: ball_query(grid[:n], centers, valid[0], radius,
                                                          16), iters=2, warmup=1)}
            del ref_idx, ref_any
            torch.cuda.empty_cache()
            print("  " + json.dumps(row))
            if not row["equal_to_dense"]:
                raise AssertionError(f"{name}: the windowed query differs from the dense one")
            rows.append(row)
    if not any(r["with_neighbours"] for r in rows):
        raise AssertionError("no grid point found a voxel")
    return rows


def phase_focal_backbone(dev):
    """The focal SECOND's 3-D backbone (VoxelBackBone8xFocal) beside the
    plain VoxelBackBone8x, each in eval mode at full width on the flagship
    batch's voxels (random weights, seed 0): device ms (CUDA events, 5
    calls), the active sites each focal layer takes in and gives out, and
    the outputs finite."""
    out = {}
    for name in ("second", "second_focal"):
        cfg = zoo_config(name)
        model = build_network("SECONDNet", cfg, device=dev, seed=0)
        with torch.inference_mode():
            batch = model.batch_to_device(flagship_batch(cfg))
            dense, mask = mean_vfe(batch["points"], batch["points_valid"], cfg.pc_range,
                                   cfg.voxel_size, cfg.grid_size)
            got = model.backbone_3d(dense, mask)
            if not bool(torch.isfinite(got[0]).all()):
                raise AssertionError(f"{name}: non-finite backbone output")
            out[name] = {"ms": cuda_ms(lambda: model.backbone_3d(dense, mask), iters=5),
                         "voxels": int(mask.sum())}
            if name == "second_focal":
                out[name]["focal_layers"] = [
                    {"active_in": int(a["active"].sum()),
                     "foreground": int(model.backbone_3d.focal1.foreground(
                         a["mask_voxel"], a["active"]).sum()) if i == 0 else None,
                     "active_out": int(got[2][f"x_conv{i + 1}"][1].sum())}
                    for i, a in enumerate(got[3])]
        del model
        torch.cuda.empty_cache()
    print("  " + json.dumps(out))
    return out


def tiny_twostage(name: str):
    """A two-stage VoD config (or the focal SECOND's) cut to TINY: 0.5 x 0.5
    x 0.125 m voxels (41 planes), 16 RoIs, 128 keypoints, a 3 x 3 IoU grid,
    16 detection slots, score threshold 0."""
    return dataclasses.replace(zoo_config(name), pc_range=TINY_RANGE,
                               voxel_size=(0.5, 0.5, 0.125), pv_num_rois=16, iou_grid_size=3,
                               pv_num_keypoints=128, nms_post_max_size=16, score_thresh=0.0)


def spread_importances(cpu_model, gpu_model, batch, scale: float = 0.5):
    """Each focal layer's importance head scaled (on both models) so that
    its logits' mean magnitude over the active sites is ``scale`` on the
    CPU's eval-mode forward: random weights in eval mode shrink the
    activations layer by layer and leave the logits at 1e-5-1e-2, every
    importance within 1e-6 of 0.5, where the devices' last bits would
    decide the foreground."""
    cfg, bb = cpu_model.cfg, cpu_model.backbone_3d
    x, mask = mean_vfe(batch["points"], batch["points_valid"], cfg.pc_range, cfg.voxel_size,
                       cfg.grid_size)
    x, mask = bb.conv_input(x, mask)
    for i, stage in enumerate((bb.conv1, bb.conv2, bb.conv3), start=1):
        x, mask = stage(x, mask)
        focal = getattr(bb, f"focal{i}")
        logits = focal.conv_imp(x * mask, torch.float32)[mask[..., 0]]
        factor = scale / float(logits.abs().mean())
        for m in (cpu_model, gpu_model):
            getattr(m.backbone_3d, f"focal{i}").conv_imp.weight.mul_(factor)
        x, mask, _ = focal(x, mask)


def focal_premise(model, batch):
    """The focal layers' importances (eval, on the CPU): every one within
    FOCAL_TIE of a frame's k-th is an exact tie, so that the card's ulp-off
    sigmoids select the same foreground."""
    cfg = model.cfg
    dense, mask = mean_vfe(batch["points"], batch["points_valid"], cfg.pc_range,
                           cfg.voxel_size, cfg.grid_size)
    _, _, _, aux = model.backbone_3d(dense, mask)
    for a in aux:
        mv, act = a["mask_voxel"].flatten(1), a["active"].flatten(1)
        for f in range(mv.shape[0]):
            vals = mv[f][act[f]].sort(descending=True).values
            kth = vals[max(int(vals.numel() * cfg.focal_threshold) - 1, 0)]
            near = vals[(vals - kth).abs() <= FOCAL_TIE]
            if not bool((near == kth).all()):
                raise AssertionError("an importance within FOCAL_TIE of the k-th: "
                                     "change TWOSTAGE_TINY_SEED")


def phase_small_reference_twostage(dev):
    """The focal SECOND, SECOND-IoU, Voxel R-CNN, PV-RCNN, PV-RCNN++ and
    Part-A2 cut to TINY (``tiny_twostage``), card vs CPU, one set of
    weights, two frames: the
    RPN's maps within 1e-4 (the focal SECOND's importance heads scaled by
    ``spread_importances``, and its foreground the same on both:
    ``focal_premise``); the proposals of the CPU's RPN maps with a ramp
    added to the class scores (the tie rule) equal on both devices; the
    second stage on those proposals within 1e-4 (PV-RCNN's and PV-RCNN++'s
    keypoints equal: the FPS kernel against its plain version; Part-A2's
    RoI-aware pools on the CPU's inputs, ``compare_parta2_pools``); the
    post-processing of the CPU's outputs equal on both devices with one NMS
    call on the card (two with the proposals, and PV-RCNN's FPS); then one
    training step on the card: finite loss terms, one NMS call (the
    proposals') for the two-stage families, one FPS for PV-RCNN's."""
    out = {}
    for name in TWOSTAGE_ZOO:
        cfg = tiny_twostage(name)
        family = bench.ZOO[name][1]
        cpu_model = build_network(family, cfg, device="cpu", seed=TWOSTAGE_TINY_SEED)
        gpu_model = build_network(family, cfg, device=dev, seed=TWOSTAGE_TINY_SEED)
        batch = tiny_center_batch(cfg)
        row = {}
        with torch.inference_mode():
            cb, gb = cpu_model.batch_to_device(batch), gpu_model.batch_to_device(batch)
            if name == "second_focal":
                spread_importances(cpu_model, gpu_model, cb)
                focal_premise(cpu_model, cb)
            c3d, c_stages, _ = cpu_model.voxel_features(cb)
            g3d, g_stages, _ = gpu_model.voxel_features(gb)
            c_bev, g_bev = height_compression(c3d), height_compression(g3d)
            c2d, g2d = cpu_model.backbone_2d(c_bev), gpu_model.backbone_2d(g_bev)
            ref, got = cpu_model.dense_head(c2d), gpu_model.dense_head(g2d)
            row["rpn_max_abs_err"] = {k: float((got[k].cpu() - r).abs().max())
                                      for k, r in ref.items()}
            for k, r in ref.items():
                torch.testing.assert_close(got[k].cpu(), r, rtol=1e-4, atol=1e-4)
            ramp = torch.linspace(0, 1.0, ref["cls_preds"].numel()).view(ref["cls_preds"].shape)
            ref = {**ref, "cls_preds": ref["cls_preds"] + ramp}
            if name == "second_focal":
                d_ref = cpu_model.post_process(ref)
                zero_launches()
                d_got = gpu_model.post_process({k: v.to(dev) for k, v in ref.items()})
                want = NMS_CALL
            else:
                props = cpu_model.rpn_proposals(ref)
                zero_launches()
                g_props = gpu_model.rpn_proposals({k: v.to(dev) for k, v in ref.items()})
                for a, b in zip(props, g_props):
                    torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5)
                c2 = cpu_model.roi_stage(cb, props[0], props[3], c_stages, c_bev, c2d)
                g2 = gpu_model.roi_stage(gb, props[0].to(dev), props[3].to(dev), g_stages, g_bev,
                                         g2d)
                row["second_stage_max_abs_err"] = {k: float((g2[k].cpu() - v).abs().max())
                                                   for k, v in c2.items()}
                if "keypoints" in c2 and not torch.equal(g2["keypoints"].cpu(), c2["keypoints"]):
                    raise AssertionError(f"{name}: the card's keypoints differ from the CPU's")
                if name == "parta2":
                    row["pools"] = compare_parta2_pools(cpu_model, gpu_model, cb, c_stages,
                                                        props[0], dev)
                for k, v in c2.items():
                    torch.testing.assert_close(g2[k].cpu(), v, rtol=1e-4, atol=1e-4)
                preds = {**ref, "rois": props[0], "roi_scores": props[1],
                         "roi_labels": props[2], "roi_valid": props[3], **c2}
                d_ref = cpu_model.post_process(preds)
                d_got = gpu_model.post_process({k: v.to(dev) for k, v in preds.items()})
                want = TWOSTAGE_FRAME[name]
            launches = dict(library.launches)
        if launches != per_frames(want, 1):
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        row.update(compare_center_detections(d_ref, d_got))
        opt, _ = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, gpu_model)
        _, step = make_train_step_for_cfg(gpu_model, opt, cfg)
        zero_launches()
        _, tb = step(gpu_model.batch_to_device(batch))
        launches = dict(library.launches)
        if launches != per_frames(TWOSTAGE_STEP[name], 1) or not all(
                math.isfinite(float(v)) for v in tb.values()):
            raise AssertionError(f"{name}: step launches {launches}, terms {tb}")
        row["step_loss_terms"] = {k: float(v) for k, v in tb.items()}
        out[name] = row
    print("  " + json.dumps(out))
    return out


FPS_K = 1024  # PFE.NUM_KEYPOINTS of configs/pvrcnn_vod.yaml
# the H100's f32 rate outside the tensor cores (NVIDIA H100 SXM datasheet)
F32_OPS_PER_S = 67e12
FPS_CASES = ("flagship", "flagship_b2", "points_16k", "proposal_centric", "ties", "short")
# the VoD dataset's MAX_POINTS (radar and virtual points), the CLIs' frames
FPS_CLI_POINTS = 16384


def fps_inputs(case: str, dev):
    """(xyz (B, N, 3) f32, valid (B, N)) of an FPS case at full width: the
    flagship batch's 8,192 points (B=1 and 2) and 16,384 (the dataset
    frames of the CLIs, radar and virtual points); those near its gt boxes
    (``sample_keypoints_proposal_centric``'s rule, the boxes as proposals);
    1,024 distinct points each repeated 8 times (exact distance ties);
    700 valid points, fewer than the 1,024 keypoints."""
    cfg = zoo_config("pvrcnn")
    batch = flagship_batch(cfg, b=2 if case == "flagship_b2" else 1,
                           max_points=FPS_CLI_POINTS if case == "points_16k" else 8192)
    xyz = torch.from_numpy(np.ascontiguousarray(batch["points"][..., :3])).to(dev)
    valid = torch.from_numpy(batch["points_valid"]).to(dev)
    if case == "proposal_centric":
        rois = torch.from_numpy(batch["gt_boxes"][..., :7]).to(dev)
        dims = rois[..., 3:6]
        half = torch.sqrt((dims[..., 0] ** 2 + dims[..., 1] ** 2) + dims[..., 2] ** 2) / 2
        d = torch.linalg.vector_norm(xyz[:, :, None, :] - rois[:, None, :, :3], dim=-1)
        near = ((d < (half + 1.6)[:, None, :]) & (rois[..., 3] > 0)[:, None, :]).any(-1)
        valid = valid & near
    elif case == "ties":
        gen = torch.Generator().manual_seed(31)
        base = xyz[:, :1024].repeat(1, 8, 1)
        xyz = base[:, torch.randperm(8192, generator=gen).to(dev)].contiguous()
    elif case == "short":
        valid = valid.clone()
        valid[:, 700:] = False
    return xyz.contiguous(), valid.contiguous()


def phase_fps(dev):
    """``hgsfusion::farthest_point_sample`` (``csrc/fps.cu``) against its
    plain version (``farthest_point_sample_plain``) at PV-RCNN's full width,
    8,192 points -> 1,024 keypoints: the flagship points at B=1 and B=2 and
    16,384 (the CLIs' frames), a proposal-centric mask, exact ties and fewer
    valid points than keypoints; the indices equal in every case. The first
    four timed: the kernel from CUDA graph replays (its ms a step and its
    cluster size printed), the chain floor (``tune_fps.CHAIN_FLOOR``: the
    kernel without its distance updates) the same way, the plain loop by
    CUDA events, beside the bound: bytes (xyz and the mask read once, the
    indices written) against operations (10 f32 operations a point a step:
    the difference, squares, sums, min and compare), and the chain of k - 1
    dependent frame-wide argmax steps. No PyTorch call computes FPS
    (library null)."""
    import tune_fps
    floor = tune_fps.chain_floor()
    rows = []
    for case in FPS_CASES:
        xyz, valid = fps_inputs(case, dev)
        got = pointnet2.farthest_point_sample(xyz, valid, FPS_K)
        ref = pointnet2.farthest_point_sample_plain(xyz, valid, FPS_K)
        b, n = valid.shape
        row = {"case": case, "batch": b, "points": n, "valid": int(valid.sum()),
               "k": FPS_K, "cluster": library.fps_plan(n)[0],
               "equal_to_plain": bool(torch.equal(got, ref)),
               "max_abs_err": float((got != ref).sum())}
        if case in tune_fps.TIMED:
            nbytes = b * n * 13 + b * FPS_K * 8
            ops = 10.0 * b * n * (FPS_K - 1)
            row.update(ms=graph_ms(lambda: pointnet2.farthest_point_sample(xyz, valid, FPS_K),
                                   iters=5),
                       chain_floor_ms=graph_ms(lambda: tune_fps.launch(floor, xyz, valid, FPS_K),
                                               iters=5),
                       plain_ms=cuda_ms(lambda: pointnet2.farthest_point_sample_plain(
                           xyz, valid, FPS_K), iters=2, warmup=1),
                       bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bound_ops_ms=ops / F32_OPS_PER_S * 1e3, chain_steps=FPS_K - 1,
                       library_ms=None)
            row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_ops_ms"])
            row["bound_by"] = ("bytes" if row["bound_bytes_ms"] >= row["bound_ops_ms"]
                               else "operations")
            row["ms_per_step"] = row["ms"] / (FPS_K - 1)
            row["chain_floor_ms_per_step"] = row["chain_floor_ms"] / (FPS_K - 1)
        print("  " + json.dumps(row))
        if not row["equal_to_plain"]:
            raise AssertionError(f"fps {case}: the kernel's indices differ from the plain "
                                 f"version's at {int(row['max_abs_err'])} places")
        rows.append(row)
    return rows


def pv_stage_ms(model, batch) -> dict:
    """PV-RCNN's second-stage pieces alone at full width (CUDA events, 5
    calls each, eval mode): the keypoints' FPS, the voxel set abstraction
    (FPS included), the keypoint weighting and the RoI-grid pool; and the
    ball queries inside them alone (the raw points' dense query, x_conv3's
    and x_conv4's windowed ones at the VSA's outer radius, the RoI grid's
    dense query of the keypoints at its outer radius), with the share of
    the RoI grid points whose ball holds no keypoint (their slots all take
    keypoint 0, and the grouping's gather backward sums them there)."""
    with torch.inference_mode():
        x3d, stages, _ = model.voxel_features(batch)
        bev = height_compression(x3d)
        rois, _, _, roi_valid = model.rpn_proposals(model.dense_head(model.backbone_2d(bev)))
        centric = (rois, roi_valid) if model.PROPOSAL_CENTRIC else ()
        keypoints, feats = model.pfe(batch["points"], batch["points_valid"], bev, stages,
                                     *centric)
        weighted, _ = model.point_head(feats)
        xyz = batch["points"][..., :3].contiguous()
        valid = batch["points_valid"][0]
        grid = roi_grid_points(rois, 6).reshape(-1, 3)
        ones = torch.ones(keypoints.shape[1], dtype=torch.bool, device=grid.device)
        queries = {"raw_0.8": cuda_ms(lambda: ball_query(keypoints[0], xyz[0], valid, 0.8, 16),
                                      iters=5),
                   "roi_grid_1.6": cuda_ms(lambda: ball_query(grid, keypoints[0], ones, 1.6, 16),
                                           iters=5)}
        for name, radii in model.pfe.STAGES:
            _, _, sv, geom = stage_point_set(stages[name], model.cfg.pc_range,
                                             model.cfg.voxel_size)
            queries[f"{name}_{radii[-1]}"] = cuda_ms(lambda: ball_query_grid(
                keypoints[0], *geom, sv[0], radii[-1], 16), iters=5)
        empty = {r: float(1.0 - ball_query(grid, keypoints[0], ones, r, 16)[1].float().mean())
                 for r in (0.8, 1.6)}
        return {"query_ms": queries, "roi_grid_empty_ball_share": empty,
            "fps_ms": cuda_ms(lambda: pointnet2.farthest_point_sample(
                xyz, batch["points_valid"], model.cfg.pv_num_keypoints), iters=5),
            "vsa_ms": cuda_ms(lambda: model.pfe(batch["points"], batch["points_valid"], bev,
                                                stages, *centric), iters=5),
            "point_head_ms": cuda_ms(lambda: model.point_head(feats), iters=5),
            "roi_grid_pool_ms": cuda_ms(lambda: model.roi_grid_pool(rois, keypoints, weighted),
                                        iters=5)}


# ---- Part-A2 ----------------------------------------------------------------
# configs/parta2_vod.yaml's proposals (ROI_HEAD.NUM_ROIS) and RoI-aware grid
# (POOL_SIZE) at full width: 128 x 8,192 (RoI, point) pairs, 6^3 cells
PARTA2_ROIS, PARTA2_POOL = 128, 6


def parta2_pool_inputs(seed: int = 0):
    """Part-A2's RoI-aware pool at full width on the CPU: the flagship
    batch's 8,192 points over configs/parta2_vod.yaml's range, 128 rotated
    RoIs (its gt boxes, jittered, then boxes of the anchors' sizes anywhere
    in the range), 16 point features as the decoder gives them (a ReLU's
    zeros, every point of one stride-1 voxel the same row: ties) and the 4
    part features (parts zeroed under a score of 0.3, the score).
    Returns (rois (1, R, 7), xyz (1, N, 3), valid (1, N), feats (1, N,
    16), part_feats (1, N, 4))."""
    cfg = zoo_config("parta2")
    batch = flagship_batch(cfg)
    rng = np.random.RandomState(seed)
    gt = batch["gt_boxes"][0]
    gt = gt[gt[:, -1] > 0, :7]
    near = np.repeat(gt, 8, axis=0)
    near[:, :3] += rng.normal(0, 0.3, near[:, :3].shape)
    near[:, 3:6] *= rng.uniform(0.8, 1.2, near[:, 3:6].shape)
    near[:, 6] += rng.normal(0, 0.3, len(near))
    n_far = PARTA2_ROIS - len(near)
    pr = cfg.pc_range
    far = np.concatenate([rng.uniform(pr[0], pr[3], (n_far, 1)), rng.uniform(pr[1], pr[4], (
        n_far, 1)), rng.uniform(-2, 0, (n_far, 1)), gt[rng.randint(len(gt), size=n_far), 3:6]
        * rng.uniform(0.8, 2.0, (n_far, 3)), rng.uniform(-np.pi, np.pi, (n_far, 1))], axis=1)
    rois = torch.from_numpy(np.concatenate([near, far])[None].astype(np.float32))
    xyz = torch.from_numpy(np.ascontiguousarray(batch["points"][..., :3]))
    valid = torch.from_numpy(batch["points_valid"])
    ids, _ = points_to_voxel_ids(xyz, valid, cfg.pc_range, cfg.voxel_size, cfg.grid_size)
    table = torch.relu(torch.from_numpy(rng.randn(int(ids.max()) + 1, 16).astype(np.float32)))
    scores = torch.from_numpy(rng.rand(1, xyz.shape[1]).astype(np.float32))[..., None]
    parts = torch.from_numpy(rng.rand(1, xyz.shape[1], 3).astype(np.float32))
    part_feats = torch.cat([torch.where(scores >= 0.3, parts, 0.0), scores], dim=-1)
    return rois, xyz, valid, table[ids], part_feats


def compare_parta2_pools(cpu_model, gpu_model, batch, stages, rois, dev) -> dict:
    """Part-A2's two RoI-aware pools on the card against the CPU on the
    CPU's inputs (its point features, scores and parts, the proposals):
    the max pool bit for bit, the mean within f32 rounding (1e-6 of the
    largest; the sums' order differs)."""
    xyz, valid = batch["points"][..., :3], batch["points_valid"]
    feats = cpu_model.point_features(batch, stages)
    seg, part = cpu_model.point_head(feats)
    args = (rois, xyz, valid, feats, torch.sigmoid(seg).amax(-1), torch.sigmoid(part))
    ref = cpu_model.roi_head.pools(*args)
    got = gpu_model.roi_head.pools(*(a.to(dev) for a in args))
    avg_err = float((got[0].cpu() - ref[0]).abs().max())
    if not torch.equal(got[1].cpu(), ref[1]):
        raise AssertionError("parta2: the card's max pool differs from the CPU's")
    if avg_err > 1e-6 * max(float(ref[0].abs().max()), 1e-6):
        raise AssertionError(f"parta2: the card's mean pool is {avg_err} off the CPU's")
    return {"max_equal": True, "avg_max_abs_err": avg_err,
            "filled_cells": int((ref[0] != 0).any(-1).sum())}


def parta2_stage_ms(model, batch) -> dict:
    """Part-A2's own stages alone at full width (CUDA events, 5 calls each,
    eval mode): the UNet decoder (with its convolutions' GFLOP), the points'
    gather of its stride-1 features, the point part head, the RoI-aware
    cells of every (RoI, point) pair, the max pool of the 16 point features,
    the mean pool of the 4 part features, and the whole RoI head (both
    pools, the conv stacks, the FCs); the pairs inside a RoI."""
    with torch.inference_mode():
        x3d, stages, _ = model.voxel_features(batch)
        rois = model.rpn_proposals(model.dense_head(model.backbone_2d(
            height_compression(x3d))))[0]
        feats = model.point_features(batch, stages)
        seg, part = model.point_head(feats)
        scores, parts = torch.sigmoid(seg).amax(-1), torch.sigmoid(part)
        xyz, valid = batch["points"][..., :3], batch["points_valid"]
        head, o = model.roi_head, model.roi_head.pool_size
        cells = roiaware_cells(rois, xyz, valid, o)
        part_feats = torch.cat([parts, scores[..., None]], dim=-1)
        flops = 0  # each level's two convolutions at its skip stage's sites
        for skip, _, name in model.unet_decoder.PLAN:
            for part in "ab":
                w = getattr(model.unet_decoder, f"{name}_{part}")[0].weight
                flops += 2 * stages[skip][0][..., 0].numel() * w.numel()
        return {"decoder_ms": cuda_ms(lambda: model.unet_decoder(stages), iters=5),
                "decoder_gflop": flops / 1e9,
                "point_features_ms": cuda_ms(lambda: model.point_features(batch, stages), iters=5),
                "point_head_ms": cuda_ms(lambda: model.point_head(feats), iters=5),
                "pool_cells_ms": cuda_ms(lambda: roiaware_cells(rois, xyz, valid, o), iters=5),
                "max_pool_ms": cuda_ms(lambda: pool_cells(cells, feats, o, "max"), iters=5),
                "avg_pool_ms": cuda_ms(lambda: pool_cells(cells, part_feats, o, "avg"), iters=5),
                "roi_head_ms": cuda_ms(lambda: head(rois, xyz, valid, feats, scores, parts),
                                       iters=5),
                "pairs": int(cells.numel()), "inside_pairs": int((cells < o ** 3).sum())}


def parta2_train_ms(model, batch) -> dict:
    """Part-A2's RoI-aware max pool in training at full width: its forward
    and its backward (the ties' counts and the split cotangent) on the
    ``parta2_pool_inputs`` pairs (CUDA events, 5 calls); the decoder's
    weight-gradient tap products a step."""
    rois, xyz, valid, feats, _ = (a.to(batch["points"].device) for a in parta2_pool_inputs())
    cells = roiaware_cells(rois, xyz, valid, PARTA2_POOL)
    x = feats.requires_grad_()
    ct = torch.randn((1, PARTA2_ROIS) + (PARTA2_POOL,) * 3 + (16,), device=x.device)

    def fwd_bwd():
        pool_cells(cells, x, PARTA2_POOL, "max").backward(ct)
        x.grad = None

    with torch.no_grad():
        fwd = cuda_ms(lambda: pool_cells(cells, feats, PARTA2_POOL, "max"), iters=5)
    return {"max_pool_ms": fwd, "max_pool_fwd_bwd_ms": cuda_ms(fwd_bwd, iters=5),
            "decoder_tap_products": conv3d_taps(model.unet_decoder)}


def phases(dev) -> list:
    """Every phase after card and build, in order: (name, function, args)."""
    def full(name, fn, *a):  # a phase after which the allocator's cache is emptied
        return (name, fn, a, True)

    def step(name, fn, *a):
        return (name, fn, a, False)

    out = [
        step("kernel_vs_plain", phase_kernel_vs_plain, dev),
        step("kernel_vs_plain_bwd", phase_kernel_vs_plain_bwd, dev),
        step("taps", phase_taps, dev),
        full("kernel_vs_plain_reduce", phase_kernel_vs_plain_reduce, dev),
        step("kernel_vs_plain_nms", phase_kernel_vs_plain_nms, dev),
        step("small_reference", phase_small_reference, dev),
        step("small_reference_train", phase_small_reference_train, dev),
        step("small_reference_radar", phase_small_reference_zoo, dev, "RadarOnly"),
        step("small_reference_pp", phase_small_reference_zoo, dev, "PointPillar"),
        full("serve", phase_serve, dev, vod_pallas_config(), GATHER_FRAME),
        full("train", phase_train, dev, vod_pallas_config(), GATHER_STEP),
        step("kernel_vs_plain_polar", phase_kernel_vs_plain_polar, dev),
        step("small_reference_polar", phase_small_reference_polar, dev),
        full("polar_vs_gather", phase_polar_vs_gather, dev),
        full("serve_polar", phase_serve, dev, vod_polar_config(), POLAR_FRAME),
        full("train_polar", phase_train, dev, vod_polar_config(), POLAR_STEP),
        step("small_reference_eval", phase_small_reference_eval, dev),
        full("eval", phase_eval, dev, "configs/hgsfusion_vod_pallas.yaml", GATHER_FRAME,
             vod_pallas_config()),
        full("eval_polar", phase_eval, dev, "configs/hgsfusion_vod_polar.yaml", POLAR_FRAME,
             vod_polar_config()),
        step("small_reference_xla", phase_small_reference_xla, dev),
        full("train_cli", phase_train_cli, dev),
        full("kernel_vs_plain_scatter", phase_kernel_vs_plain_scatter, dev),
        full("bench_scatter", phase_bench_scatter, dev),
        step("small_reference_tj4d", phase_small_reference_tj4d, dev),
    ]
    for view, path, per_frame in (("pallas", "serve_tj4d", GATHER_FRAME),
                                  ("polar", "serve_tj4d_polar", POLAR_FRAME)):
        out.append(full(path, phase_serve_tj4d, dev, view, per_frame))
    out += [
        full("train_cli_tj4d", phase_train_cli_tj4d, dev),
        full("eval_tj4d_polar", phase_eval, dev, TJ4D_YAMLS["polar"], POLAR_FRAME),
        full("export_serve", phase_export_serve, dev, "export_serve", vod_pallas_config(),
             GATHER_FRAME),
        full("export_serve_polar", phase_export_serve, dev, "export_serve_polar",
             vod_polar_config(), POLAR_FRAME),
        step("bench", phase_bench, dev),
        step("small_reference_rhgm", phase_small_reference_rhgm, dev),
        full("rhgm", phase_rhgm, dev),
        full("ddp", phase_ddp, dev),
        full("eval_multiproc", phase_eval_multiproc, dev),
        full("tta", phase_tta, dev),
        full("study_small", phase_study_small, dev),
        full("depth_kernels", phase_depth_kernels, dev),
        full("serve_depth", phase_serve_depth, dev),
        full("train_depth", phase_train_depth, dev),
        full("train_cli_depth", phase_train_cli_depth, dev),
        full("export_serve_depth", phase_export_serve, dev, "export_serve_depth",
             depth_config(), DEPTH_FRAME),
        full("kernel_vs_plain_q8", phase_kernel_vs_plain_q8, dev),
        full("kernel_vs_plain_w8a8", phase_kernel_vs_plain_w8a8, dev),
        full("serve_q8", lambda: phase_serve(dev, yaml_config(Q8_YAML), Q8_FRAME)),
        full("train_q8", lambda: phase_train(dev, yaml_config(Q8_YAML), Q8_STEP)),
        full("eval_q8", phase_eval, dev, Q8_YAML, Q8_FRAME, None, Q8_EVAL_FRAMES),
        full("export_serve_q8", lambda: phase_export_serve(dev, "export_serve_q8",
                                                           yaml_config(Q8_YAML), Q8_FRAME)),
        step("serving_host_start", phase_serving_host_start, dev),
        full("serve_w8a8", phase_serve_w8a8, dev, "gather"),
        full("serve_w8a8_polar", phase_serve_w8a8, dev, "polar"),
        full("serve_occ_v2", phase_serve_occ_v2, dev),
        step("train_occ_v2", lambda: phase_train(dev, yaml_config(OCC_V2_YAML), GATHER_STEP)),
        full("serve_radar", lambda: phase_serve_zoo(dev, "RadarOnly", radar_config(),
                                                    radar_batch(radar_config()))),
        full("train_radar", lambda: phase_train_zoo(dev, "RadarOnly", radar_config(),
                                                    radar_batch(radar_config()))),
        full("train_cli_radar", phase_train_cli_radar, dev),
        full("serve_pp_multihead", lambda: phase_serve_zoo(dev, "PointPillar", pp_config(),
                                                           nuscenes_batch(pp_config()))),
        full("train_pp_multihead", lambda: phase_train_zoo(
            dev, "PointPillar", pp_config(), nuscenes_batch(pp_config(), b=PP_TRAIN_BATCH))),
        full("demo", phase_demo, dev),
        full("depth_kernels_bevfusion", phase_depth_kernels_bevfusion, dev),
        step("small_reference_bevfusion", phase_small_reference_bevfusion, dev),
        full("serve_bevfusion", lambda: phase_serve_family(
            dev, "bevfusion", bevfusion_config(), flagship_batch(bevfusion_config()), BEV_FRAME)),
        full("train_bevfusion", phase_train_bevfusion, dev),
        full("train_cli_bevfusion", phase_train_cli_family, dev, BEV_YAML, BEV_STEP,
             BEV_FRAME),
        full("serve_transfusion", lambda: phase_serve_family(
            dev, "transfusion", transfusion_config(), radar_batch(transfusion_config()), {})),
        full("train_cli_transfusion", phase_train_cli_family, dev, TF_YAML, {}, {}),
        step("nms_center", phase_nms_center, dev),
        step("top_scores", phase_top_scores, dev),
        step("small_reference_center", phase_small_reference_center, dev),
    ]
    for name in CENTER_ZOO:
        out.append(full(f"serve_{name}", lambda n=name: phase_serve_family(
            dev, n, zoo_config(n), flagship_batch(zoo_config(n)), NMS_CALL)))
    out.append(full("serve_centerpoint_nuscenes", lambda: phase_serve_family(
        dev, "centerpoint_nuscenes", cp_nuscenes_config(),
        cp_nuscenes_batch(cp_nuscenes_config()), NMS_CALL, family="CenterPoint")))
    for name in ("centerpoint", "second", "voxelnext"):
        out.append(full(f"train_{name}", lambda n=name: phase_train_zoo(
            dev, bench.ZOO[n][1], zoo_config(n), flagship_batch(zoo_config(n)))))
    out += [
        full("train_centerpoint_nuscenes", lambda: phase_train_zoo(
            dev, "CenterPoint", cp_nuscenes_config(),
            cp_nuscenes_batch(cp_nuscenes_config(), b=CENTER_TRAIN_BATCH))),
        full("train_cli_centerpoint", phase_train_cli_family, dev,
             bench.ZOO["centerpoint"][0], {}, NMS_CALL),
        full("train_cli_second", phase_train_cli_family, dev,
             bench.ZOO["second"][0], {}, NMS_CALL),
        step("nms_twostage", phase_nms_twostage, dev),
        full("ball_query", phase_ball_query, dev),
        full("focal_backbone", phase_focal_backbone, dev),
        step("small_reference_twostage", phase_small_reference_twostage, dev),
        step("fps", phase_fps, dev),
    ]
    for name in ("voxelrcnn", "second_iou", "pvrcnn", "parta2"):
        out.append(full(f"train_cli_{name}", phase_train_cli_family, dev, bench.ZOO[name][0],
                        TWOSTAGE_STEP[name], TWOSTAGE_FRAME[name], f"export_{name}"))
    # the CLI exports' artifacts served while the two-stage paths run
    out.append(step("serving_host_start_cli", phase_serving_host_start, dev))
    for name in TWOSTAGE_ZOO:
        out.append(full(f"serve_{name}", lambda n=name: phase_serve_family(
            dev, n, zoo_config(n), flagship_batch(zoo_config(n)), TWOSTAGE_FRAME[n])))
    for name in TWOSTAGE_ZOO:
        out.append(full(f"train_{name}", lambda n=name: phase_train_zoo(
            dev, bench.ZOO[n][1], zoo_config(n), flagship_batch(zoo_config(n)),
            per_step=TWOSTAGE_STEP[n])))
    # every serving host checked, last
    out.append(step("serving_host", phase_serving_host, dev))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--phases", help="run card, build and only these phases (comma-separated "
                    "names, as printed in brackets); every phase by default")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity phases: full f32
    torch.backends.cudnn.allow_tf32 = False
    plan = phases(dev)
    if args.phases:
        wanted = [p for p in args.phases.split(",") if p]
        unknown = sorted(set(wanted) - {name for name, *_ in plan})
        if unknown:
            print(f"chip_smoke: unknown phases {unknown}; known: "
                  f"{[name for name, *_ in plan]}", file=sys.stderr)
            return 2
        if any(p.startswith("export_serve") or p in ("train_cli_radar", "train_cli_voxelrcnn",
                                                     "train_cli_second_iou", "train_cli_pvrcnn",
                                                     "train_cli_parta2")
               for p in wanted):
            wanted.append("serving_host")  # the exported artifacts are served there
        plan = [p for p in plan if p[0] in wanted]
    failed, report = [], {}

    def phase(name, fn, *a):
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            report[name] = fn(*a)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED", flush=True)
            failed.append(name)

    phase("card", card_line)
    print("  " + str(report.get("card")))
    phase("build", native.build, KERNEL_SOURCES)
    for name, r in (report.get("build") or {}).items():
        print(f"  {name}: {r['seconds']:.1f} s\n" + r["ptxas"].strip())
    for name, fn, a, empty_cache in plan:
        phase(name, fn, *a)
        if empty_cache:
            torch.cuda.empty_cache()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    def summed(rows, key):
        vals = [r[key] for r in rows if "ms" in r]
        return None if None in vals else sum(vals)

    def by_path(name):
        # the launches on each main path this run drove
        return {path: report[path]["launches"].get(name, 0) for path in MAIN_PATHS
                if path in report}

    def kernel_row(name, source, replaces, rows, polar_rows=None):
        # per frame or step: the bf16 calls of the gather path (A, B) summed,
        # and of the polar path (its three maps) beside them
        timed = [r for r in rows if "ms" in r]
        polar_block = {} if polar_rows is None else {"polar": {
            "max_abs_err": max(r["max_abs_err"] for r in polar_rows),
            **{k: summed(polar_rows, k) for k in ("ms", "route_ms", "plain_ms", "bound_ms",
                                                  "library_ms") if k in polar_rows[0]}}}
        paths = by_path(name)
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": summed(rows, "ms"), "plain_ms": summed(rows, "plain_ms"),
            "bound_ms": summed(rows, "bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in timed)
            else "operations",
            "library_ms": summed(rows, "library_ms"),
            **{k: summed(rows, k) for k in ("route_ms",) if k in timed[0]},
            **{k: timed[0][k] for k in ("library", "library_pair", "library_pair_ms",
                                        "sampling_route_ms") if k in timed[0]},
            **polar_block,
        }

    # a row for each kernel whose phase ran (all of them without --phases)
    kernels = []
    if "kernel_vs_plain" in report and "kernel_vs_plain_polar" in report:
        kernels.append(kernel_row(
            library.KERNEL, "hgsfusion_tpu_torch/csrc/quad_sample.cu",
            "hgsfusion_tpu/ops/pallas_sample.py:108",
            [r for r in report["kernel_vs_plain"]
             if r["case"] in FLAGSHIP_SHAPES and r["dtype"] == "bfloat16"],
            [r for r in report["kernel_vs_plain_polar"]["fwd"] if r["dtype"] == "bfloat16"]))
    if "kernel_vs_plain_bwd" in report and "kernel_vs_plain_polar" in report:
        kernels.append(kernel_row(
            library.BWD_KERNEL, "hgsfusion_tpu_torch/csrc/quad_sample_bwd.cu",
            "hgsfusion_tpu/ops/pallas_sample.py:226",
            [r for r in report["kernel_vs_plain_bwd"] if "ms" in r],
            report["kernel_vs_plain_polar"]["bwd"]))
    if "kernel_vs_plain_reduce" in report:
        kernels.append(kernel_row(
            library.REDUCE_KERNEL, "hgsfusion_tpu_torch/csrc/quad_sample_reduce.cu",
            "_bench_gather_pallas.py:162",
            [r for r in report["kernel_vs_plain_reduce"]["rows"] if "ms" in r]))
    if "kernel_vs_plain_scatter" in report:
        rows = [r for r in report["kernel_vs_plain_scatter"] if "ms" in r]
        kernels.append(kernel_row(row_scatter.KERNEL,
                                  "hgsfusion_tpu_torch/csrc/row_scatter_add.cu",
                                  "_bench_scatter_pallas.py:69", rows))
        kernels[-1]["cases"] = {r["case"]: {k: r[k] for k in (
            "ms", "binning_ms", "kernel_only_ms", "plain_ms", "library_ms", "bound_ms")}
            for r in rows}
    # the depth-weighted sampler: no TPU kernel (XLA), held like the others
    if "depth_kernels" in report:
        depth = report["depth_kernels"]
        for name, rows in ((library.DEPTH_KERNEL, depth["fwd"]),
                           (library.DEPTH_BWD_KERNEL, depth["bwd"])):
            kernels.append(kernel_row(name, "hgsfusion_tpu_torch/csrc/quad_sample_depth.cu",
                                      "none: XLA _sample_with_depth, "
                                      "hgsfusion_tpu/models/frustum.py:221", rows))
    # BEVFusion's shapes: a block on the D1, D2 and K2 rows, each
    # dtype's timed call (B=1, 40,000 queries); a row of its own where the
    # flagship phase did not run (``--phases``)
    if "depth_kernels_bevfusion" in report:
        bev = report["depth_kernels_bevfusion"]
        sources = {library.DEPTH_KERNEL: ("hgsfusion_tpu_torch/csrc/quad_sample_depth.cu",
                                          "none: XLA _sample_with_depth, "
                                          "hgsfusion_tpu/models/frustum.py:221", bev["fwd"]),
                   library.DEPTH_BWD_KERNEL: ("hgsfusion_tpu_torch/csrc/quad_sample_depth.cu",
                                              "none: XLA _sample_with_depth, "
                                              "hgsfusion_tpu/models/frustum.py:221", bev["bwd"]),
                   library.BWD_KERNEL: ("hgsfusion_tpu_torch/csrc/quad_sample_bwd.cu",
                                        "hgsfusion_tpu/ops/pallas_sample.py:226", bev["k2"])}
        for name, (source, replaces, rows) in sources.items():
            timed = [r for r in rows if "ms" in r]
            row = next((k for k in kernels if k["name"] == name), None)
            if row is None:
                row = kernel_row(name, source, replaces,
                                 [r for r in timed if r["dtype"] == "float32"])
                kernels.append(row)
            row["bevfusion"] = {
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "queries": rows[0]["queries"],
                **{r["dtype"]: {k: r.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms")} for r in timed}}
    # F2V QUANT int8's two kernels and DDN QUANT w8a8's convolution: no TPU
    # kernel (XLA), held like the others
    if "kernel_vs_plain_q8" in report:
        q8 = report["kernel_vs_plain_q8"]
        kernels.append(kernel_row(library.Q8_KERNEL, "hgsfusion_tpu_torch/csrc/quad_sample.cu",
                                  "none: XLA _q8_sample_impl, "
                                  "hgsfusion_tpu/ops/grid_sample.py:210",
                                  [r for r in q8["fwd"] if "ms" in r]))
        kernels.append(kernel_row(library.REDUCE_Q8_KERNEL,
                                  "hgsfusion_tpu_torch/csrc/quad_sample_reduce.cu",
                                  "none: XLA, hgsfusion_tpu/models/frustum.py:364",
                                  [r for r in q8["reduce"] if "ms" in r]))
    if "kernel_vs_plain_w8a8" in report:
        w8 = report["kernel_vs_plain_w8a8"]
        paths = by_path(library.CONV_W8A8)
        kernels.append({
            "name": library.CONV_W8A8, "route": "cuda",
            "source": "hgsfusion_tpu_torch/csrc/conv_int8.cu",
            "replaces": "none: XLA lax.conv_general_dilated on int8, "
                        "hgsfusion_tpu/models/resnet.py:75",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in w8["rows"]),
            **{k: w8["backbone"][k] for k in W8A8_SUMS + ("bound_by",)},
            "library": "cuDNN F.conv2d in bf16 over the backbone's 104 convolutions",
            "shapes": [{k: r.get(k) for k in ("shape", "count", "tile_n")
                        + W8A8_SUMS + ("bound_by",)} for r in w8["rows"]],
        })
        paths = by_path(library.QUANTIZE_INT8)
        total = w8["backbone"]
        kernels.append({
            "name": library.QUANTIZE_INT8, "route": "cuda",
            "source": "hgsfusion_tpu_torch/csrc/conv_int8.cu",
            "replaces": "none: XLA, the quantization of hgsfusion_tpu/models/resnet.py:80-81",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": total["quantize_max_abs_err"], "ms": total["quantize_ms"],
            "plain_ms": total["quantize_plain_ms"],
            "bound_ms": total["quantize_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
        })
    # NMS's two kernels: the worst case (4,096 valid, 500 kept) as the row,
    # every case in it; the op's time and the greedy rule's bound beside
    if "kernel_vs_plain_nms" in report:
        nms_rows = report["kernel_vs_plain_nms"]
        worst = nms_rows[0]
        timed = [r for r in nms_rows if "ms" in r]
        common = {"route": "cuda", "source": "hgsfusion_tpu_torch/csrc/nms_lazy.cu",
                  "replaces": "none: hgsfusion_tpu/ops/nms.py:24 (XLA lax.while_loop)",
                  "library_ms": None, "op_ms": worst["ms"], "op_plain_ms": worst["plain_ms"],
                  "op_bound_ms": worst["bound_ms"]}
        for name, key, err in ((library.NMS_MASK, "mask", "mask_tie_bits"),
                               (library.NMS_SWEEP, "sweep", None)):
            paths = by_path(name)
            kernels.append({
                "name": name, **common, "launches": sum(paths.values()),
                "launches_by_path": paths,
                # the mask: bits off the plain mask's (all at IoU ties); the
                # sweep: keep decisions off its plain version's (none allowed)
                "max_abs_err": float(sum(r[err] for r in nms_rows) > 0) if err else 0.0,
                "ms": worst[f"{key}_ms"], "plain_ms": worst[f"{key}_plain_ms"],
                "bound_ms": worst[f"{key}_bound_ms"],
                "bound_by": worst.get(f"{key}_bound_by", "bytes"),
                "tie_decisions": sum(r["tie_decisions"] for r in nms_rows),
                "cases": {r["case"]: {k: r.get(k) for k in (
                    "kept", "ms", f"{key}_ms", "plain_ms", f"{key}_plain_ms", "route_ms",
                    "plain_route_ms", "bound_ms", f"{key}_bound_ms", "mask_circle_tests",
                    "mask_iou_evals")} for r in timed},
            })
            # the center families' shapes (500 decoded candidates), where
            # that phase ran too; alone, its rows stay under "nms_center"
            for block, phase_name in (("center", "nms_center"), ("twostage", "nms_twostage")):
                if phase_name in report:
                    kernels[-1][block] = {r["case"]: {k: r.get(k) for k in (
                        "kept", "equal_to_plain", "ms", f"{key}_ms", "plain_ms",
                        f"{key}_plain_ms", "bound_ms", f"{key}_bound_ms")}
                        for r in report[phase_name]}
    # FPS (PV-RCNN's keypoints): no TPU kernel (XLA lax.fori_loop)
    if "fps" in report:
        timed = [r for r in report["fps"] if "ms" in r]
        paths = by_path(library.FPS)
        kernels.append({
            "name": library.FPS, "route": "cuda", "source": "hgsfusion_tpu_torch/csrc/fps.cu",
            "replaces": "none: XLA lax.fori_loop, hgsfusion_tpu/ops/pointnet2.py:20",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in report["fps"]),
            **{k: timed[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "bound_bytes_ms", "bound_ops_ms", "chain_steps",
                                        "ms_per_step", "cluster", "chain_floor_ms")},
            "cases": {r["case"]: {k: r.get(k) for k in ("batch", "valid", "cluster",
                                                       "equal_to_plain", "ms", "ms_per_step",
                                                       "chain_floor_ms", "plain_ms", "bound_ms")}
                      for r in report["fps"]},
        })
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": report["card"], "kernels": kernels, **report}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
