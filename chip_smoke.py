"""Smoke run of the PyTorch/CUDA port (hyperreel_tpu_torch) on one NVIDIA
GPU: the flagship eval render (technicolor_z_plane), the static
multi-axis families' (llff_z_plane; shiny_z_plane, RGB colour), the
dynamic multi-axis family's (neural_3d_z_plane, 64 samples per ray), the
single-axis RGB net's own fused route (stanford_llff_z_plane), the
non-planar primitive presets' own fused routes (catacaustics_distance at
the [8, 8, 8] layout, immersive_sphere_new on time planes, donerf_sphere)
and the flagship's single-axis own route, and the render-time sample
counts (compaction and the stride) of the flagship, neural_3d_z_plane and
shiny_z_plane, at full width through the hand-written kernels, checked
against their plain PyTorch versions and against the port's general path,
on the quad route and on the coherent patch-gather routes; the standalone
composite entry point; the flagship's training step across its grid
events, with the trained model rendered through K1 and K2; and the
training of llff_z_plane and shiny_z_plane across their grid events and
of neural_3d_z_plane, with the trained models rendered through K1, K5, K6
and K4 + K5-preblended; and training from scenes on disk, through the
port's loaders and ray store: the flagship from a Technicolor scene at the
published rig and resolution, llff_z_plane from an LLFF scene at its
published setting, their held-out views through K1 + K2 and K1 + K5; and
the user's entry points: the flagship trained, evaluated, rendered along
a spiral and exported as a mesh through the CLI
(`hyperreel_tpu_torch.main`), the viewer's resolution ladder and its HTTP
server on the trained flagship, and llff_z_plane trained and evaluated
through the CLI with its visualizers; data-parallel training (one rank
over NCCL through System.fit, two ranks over gloo against one process);
and the last model families: technicolor_cascaded trained through the CLI
and evaluated through K2, blender_voxel trained and rendered at 192
samples through the general chain, refnerf_sphere_reflect,
refnerf_sphere and shiny_z_deformable trained and rendered through K5;
and the colour side: the six shade kernels at SH degrees 0, 1, 3 and 4,
the SH-3 flagship's and SH-4 llff's frames on every route, the flagship
with a per-camera colour transform trained through the CLI, the time
heads, MLP_Fea, tensor_vm, tensor_cp and the standalone march; and the
prediction side: K1 at every layer and field activation and at wider
encodings, the long-tail flagship trained through the CLI and rendered
through K1 + K2 and K1 + K3, the angular flow, ray outputs and every ray
param through the general chain.

    python3 chip_smoke.py

Phases (any failure raises; the process then exits non-zero and prints
no result line):
  1. the card's name and power limit (nvidia-smi); no CUDA card -> error;
  2. build the kernels from hyperreel_tpu_torch/csrc/ (one nvcc per
     source, all at once, sm_90a);
  3. the flagship (technicolor_z_plane, bf16 MLP policy) with weights
     drawn from a seeded torch.Generator, its prepared tables, it=20000;
     on one 262,144-ray chunk of the bench frame, K1 and K2 against their
     plain versions (error and CUDA-event times), K1 also under the f32
     MLP policy, and the chunk's colour through both kernels against the
     colour through both plain versions; K1's plan (rays per block, the
     weight slabs' bytes per chunk from L2, TFLOP/s) beside six bf16
     torch.matmul calls at the chunk's shapes, a cuBLAS yardstick;
  4. the 1024x1024 bench frame (4 chunks, t=0.3) through model.apply on
     the quad route: finite, in [0, 1], K1 and K2 launched once per chunk;
  5. fused vs general path on 4096 rays of __graft_entry__.entry()'s
     recipe;
  6. the patch route's kernels on the same chunk: K3 (fused blend+shade)
     at R=8 (5, 2) on the chunk in bench.py's phase-major order and at
     R=4 (4, 3) in scanline order, K4 (patch blend) and K2 reading its
     pre-blended features, each against its plain version; K2, K2
     reading K4's features and K3 with RGB colour (a random [3, C] basis)
     against their plain versions; the patch kernels timed in turns with
     K2; K7 (composite) at B=262,144, S=32 through its entry point;
  7. the bench frame on the patch route, R=8 (5, 2) as bench.py renders it
     (phase-major rays, rays_phase_major=True) and in scanline order, on
     K3 and on the two-kernel route (HYPERREEL_FUSED_PATCH=0, K4 then
     K2-preblended): the launches, the coverage witness (<= 1e-4, bench.py
     PVIOL_EXACT) and the rgb against the quad route's frame (<= 2e-4);
  8. frame time of the three routes, 10 frames after a warm-up frame
     each, in turns quad, fused, two-kernel, two-kernel, fused, quad,
     twice (CUDA events);
  9. llff_z_plane (bf16 MLP policy, mipnerf contraction, [8, 4, 4]
     components) on a trained checkpoint's grid: N_voxel_init set to
     N_voxel_final (262,144,000 voxels), whose bf16 quad tables (~116 MB)
     exceed the card's 50 MB L2; weights from a seeded torch.Generator with
     the density planes and lines redrawn uniform in [0, 0.05);
 10. on one chunk of the bench frame (o, d only: a static scene): K1 with
     the contraction and no flow stage (bf16 and f32 MLP policies), K5
     (multi-axis shade; its persistent grid and carve-out), K4 on each of
     the three planes, K5 reading their pre-blended features, and K6
     (fused multi-axis patch shade) at R=8 (5, 2) on the phase-major
     chunk, each against its plain version, the witness counts equal; the
     share of valid samples (>= 25 %); each kernel's CUDA-event time in
     turns on the phase-major chunk, K5's also on the chunk in scanline
     order (as the quad route gives it), and its plain version's; K5 on
     the same pack with the init grid's L2-resident tables, in turns with
     the checkpoint grid's; K1's plan and yardstick as phase 3;
 11. the bench frame on llff's routes through model.apply: quad (K1, K5),
     fused patch (HYPERREEL_FUSED_PATCH_MULTI=1: K1, K6) and two-kernel
     patch (K1, K4 x 3, K5-preblended) at R=8 (5, 2), and both patch
     routes at R=4 (4, 3): finite, in [0, 1], the launches per chunk, the
     coverage witness, and the rgb within 2e-4 of the quad route's frame
     where the witness is <= 1e-4 (printed where it is not; at R=4 the
     witness must be <= 1e-4);
 12. llff fused vs general path on 4096 rays, f32 MLP policy (<= 2e-4);
 13. frame time of llff's routes in turns, as phase 8;
 14. neural_3d_z_plane (bf16 MLP policy, S=64, flow and mipnerf
     contraction, [8, 4, 4] components on three space-plane x time-plane
     axes, 12 keyframes of a 50-frame window) on a trained checkpoint's
     grid (N_voxel_init set to N_voxel_final), weights from a seeded
     torch.Generator with the density grids redrawn uniform in [0, 0.05);
 15. on one chunk of the bench frame (t = 0.3): K1 at S=64 (bf16 and f32
     MLP policies), K5 on the time planes (TH=12, the time coordinate
     mixed per sample), on the same chunk with a t per ray spread over
     all 12 keyframes and on the planes premixed for t, K4 on each plane
     and K5-preblended at R=8 (5, 3) on the phase-major chunk, K6 at R=8
     (5, 3) and at R=4 (4, 3), each against its plain version, the witness
     counts equal; the share of valid samples (>= 25 %); each kernel's
     CUDA-event time in turns, and its plain version's; K1's plan and
     yardstick as phase 3;
 16. the bench frame through model.apply with uniform_time (the time
     planes premixed) and without it (K5/K6 on the time planes), on the
     quad route (K1, K5), the two-kernel (K1, K4 x 3, K5-preblended) and
     the fused (K1, K6) patch routes at R=8 (5, 3) and R=4 (4, 3): finite,
     in [0, 1], the launches per chunk, both witnesses, and the rgb within
     2e-4 of the quad route's frame with one t where the coverage witness
     is <= 1e-4 (at R=4 it must be);
 17. n3d fused vs general path on 4096 rays with random times, f32 MLP
     policy (<= 2e-4);
 18. frame time of n3d's quad route with one t and with a t per ray, and
     of its patch routes with one t, in turns;
 19-23. shiny_z_plane (two-plane rays, identity contraction, RGB colour,
     the llff layout) as phases 9-13, on its checkpoint grid (planes
     806x806, 403x806, 403x806; ~125 MB of quad tables), the density
     planes and lines redrawn uniform in [0, 0.2); K1, K5, K4 x 3,
     K5-preblended and K6 with RGB colour against their plain versions,
     K5 also with the weights row, the valid share, the frames on the
     three routes with their witnesses and rgb gates, fused vs general
     path, the frame through the general chain and the net's own fused
     route (fused_render_cf off: K5 with the weights row, once per chunk),
     its first chunk against the quad route, and the routes' frame times;
 24. stanford_llff_z_plane (two-plane rays with near/far, one plane x line
     axis, RGB colour) on its checkpoint grid (the plane 1007x1007, the
     line 503; a ~130 MB quad table), the density plane and line redrawn
     uniform in [0, 0.3); it takes the general stage chain and its net's
     own fused route;
 25. on one chunk: K2 with RGB colour, the weights row and the z line as
     its premixed table against its plain version; the valid share;
 26. the bench frame through model.apply: finite, in [0, 1], K2 launched
     once per chunk and nothing else;
 27. the frame against the general colour net (<= 2e-4);
 28. frame time of the own route and of the general path, in turns;
 29-32. catacaustics_distance (static, euclidean distance intersect with
     the dataset bounds near 0.1, far 10, depth range (0.1, 10), mipnerf,
     SH, [8, 8, 8] components, S = 64, the global colour scale and shift)
     on its checkpoint grid (400^3: three 400x400x16 planes, ~62 MB of
     quad tables), the camera at (0, 0, -8): on one chunk the general
     chain, then K5 at [8, 8, 8] with the weights row against its plain
     version, the valid share (>= 50 %); the frame through model.apply
     (K5 once per chunk, no K1); against the general colour net (<= 2e-4);
     the frame times of both and where the own route's goes;
 33-36. immersive_sphere_new (dynamic, outward-facing sphere_new
     intersect with near/far (1, 10), depth range (2, 10), flow, [8, 4, 4]
     on time planes, 12 keyframes of 50 frames, S = 32) on its checkpoint
     grid (640^3, ~105 MB of quad tables), the camera inside the spheres:
     as 29-32, with one t and with a t per ray (K5 on the time planes);
 37-40. donerf_sphere (static, sphere intersect, RGB, [8, 4, 4], the
     weights row, S = 32) on its checkpoint grid (600^3): as 29-32;
 41-43. the flagship with fused_render_cf off: the general chain, then K2
     on its time plane (the net's single-axis own route) against its plain
     version, the bench frame (K2 once per chunk, nothing else) against
     the general colour net (<= 2e-4) and the channels-first route's
     frame (printed), the own and channels-first routes under the f32 MLP
     policy on 16,384 rays (<= 2e-4 over the rays without a sample on an
     aabb face), and the frame times of the own route and the general
     path;
 44-53. the render-time sample counts: technicolor_z_plane with
     with_compact_samples(16) (K1's first-k branch, invalid samples at the
     far sentinel), with_inference_samples(8) and (16) (K1's positional
     stride 4 and 2), neural_3d_z_plane with with_inference_samples(16)
     (stride 4 at S = 64) and shiny_z_plane with with_compact_samples(16),
     on the weights of the phases above: on one chunk K1's branch against
     its plain version under both MLP policies (the sentinel samples'
     points, ~1e8 outside the aabb, held relatively, 1e-6), the shade
     kernels at S = k against theirs (K2 at S = 8 and 16; with compaction
     K3, K4 and K2-preblended at R=8 (5, 2) on the phase-major chunk; n3d's
     K5 on the time planes with one t and a t per ray and premixed;
     shiny's K5 with RGB colour; for n3d at R=8 (5, 3) and shiny at R=4
     (4, 3) the multi-axis patch routes' kernels: K4 in one launch over the
     three planes, K5-preblended on its features and K6, with their
     witness counts equal), each timed in turns, with its plain version's
     time and its bound counting the k samples; the bench frame through
     model.apply on the quad route (the flagship with compaction also its
     two patch routes; n3d and shiny also their two-kernel and fused patch
     routes, n3d's two-kernel route also on the time planes without the
     premix; each patch route's coverage witness <= 1e-4 and its rgb
     within 2e-4 of the quad route's; n3d's quad route also with a random
     t per ray): finite, in [0, 1], the launches per chunk; the flagship
     with compaction fused vs general path under the f32 MLP policy (<=
     2e-4); the routes' frame times in turns with the family's full-S quad
     route;
 54. training (hyperreel_tpu_torch/train/): the flagship at full width
     (bf16 MLP policy, the preset's 161x161 space plane and 4x80 time
     plane, bf16 tables) with its alpha-mask event moved to iteration 20
     and its first upsample to 30 (the preset's schedule: ~6.3 M
     voxels), DEFAULT_TRAINING (16,384 rays, four optimizer groups) and
     tv_4000, on the blob scene (16 views x 128^2 x 8 frames, marched on
     the card): 60 steps of Trainer.fit; every loss and param finite, the
     mean image loss of the last 5 steps below the first 5's, grid_size
     after the upsample as n_to_reso gives it, the optimizer's counters
     restarted at each event; whether the shrink moved the aabb (if not,
     net.shrink to a tighter box, so that phase 56 renders on another
     aabb either way); each event's wall time;
 55. the step's time on the initial and on the upsampled grid: ms per
     step over 20 steps after a warm-up (CUDA events), its split into
     forward, backward and optimizer (CUDA events between them), the
     lookups' backward's share of the device time (torch.profiler), every
     gradient finite, the peak of allocated memory;
 56. the trained model's bench frame through model.apply on the quad
     route: K1 and K2 once per chunk, finite, in [0, 1]; on one chunk K1
     and K2 against their plain versions; fused vs general path under
     the f32 MLP policy on 4096 rays (<= 2e-4);
 57. save a checkpoint, restore it into a fresh model and trainer, take
     one step on both: the same loss, the params within two f32 ulps;
 58. training the static net: llff_z_plane at full width (the preset's
     grid, 2,097,152 voxels over its aabb, [8, 4, 4] components; the bf16
     MLP policy and tables; the mipnerf contraction with the static blob
     scene's depth range) with its first two upsamples moved from 4,000
     and 6,000 to 20 and 30, DEFAULT_TRAINING and tv_4000, on the static
     blob scene (16 views x 128^2, marched on the card): 60 steps of
     Trainer.fit; every loss and param finite, the last 5 image losses'
     mean below the first 5's, grid_size as n_to_reso gives it, each
     optimizer counter restarted at each event;
 59. its step on the initial and the upsampled grid, as phase 55 (the
     lines' backward, _Quad1dBackward, beside the planes');
 60. the trained llff model's bench frame through model.apply on the quad
     route (K1 + K5), the fused patch route (K6) and the two-kernel route
     (K4 + K5-preblended) at R=4 (4, 3): finite, in [0, 1], the launches
     per chunk, each patch route's witness <= 1e-4 and its rgb within
     2e-4 of the quad route's; on one chunk K1, K5, K4, K5-preblended and
     K6 against their plain versions, timed; fused vs general under the
     f32 MLP policy on 4096 rays (<= 2e-4);
 61. shiny_z_plane (RGB) as 58-60 with its alpha event moved to 20 and its
     first upsample to 30: the shrink moves the aabb and crops the planes
     and lines (if the event leaves the box, net.shrink to a tighter one),
     the step's time, the trained model's frame on the quad route (K1 + K5
     with RGB colour) with K1 and K5 against their plain versions;
 62. neural_3d_z_plane at full width (64 samples, [8, 4, 4] time planes of
     n3d_info()'s 12 keyframes, the dynamic blob scene) with no events: 20
     steps of Trainer.fit, the step's time, the trained model's frame
     through K1 + K5 on the time planes, each against its plain version on
     one chunk;
 63. the trained llff model checkpointed, restored into a fresh model and
     trainer, one step on both under torch's deterministic algorithms: the
     same loss, the params equal to the bit;
 64. a Technicolor scene ("painter") written into a temporary directory
     from SEED (PNG by a stdlib writer, smooth fields that differ per
     camera and frame): the 4 x 4 rig at 2048 x 1088, 9 frames of the
     published 50-frame window (5 where the host lacks the RAM or disk,
     printed; the cut takes the time planes from 12 keyframes to 2),
     keyframe_step 4, load_full_step 8, camera (2, 2) held out; both
     splits through the port's loader (s per image, peak RSS), the train
     rays counted exactly (100,270,080: 15 cameras x 2,228,224 x (2 + 1/4
     + 6/8)) and written as the port's MmapRayStore; technicolor_z_plane
     (bf16) built with the loader's dataset_info and trained 60 steps of
     16,384 rays from the store's C++ sampler (the image loss falls as in
     54); the sampler's ms per batch of 16,384 and 262,144 rays against
     the in-memory batch_iterator and the step; the held-out camera's
     frame 4 (2,228,224 rays in 9 chunks) through model.apply on the quad
     route: K1 and K2 launched once per chunk, finite, in [0, 1], its ms
     and PSNR against the image; on its first chunk K1 and K2 against
     their plain versions (the gates of phases 3 and 56);
 65. an LLFF scene of 20 views (poses_bounds.npy of a 4032 x 3024 capture,
     the images at 1008 x 756, the rays of the published downsample=4)
     through the port's loader: val_skip 8 holds out views 0, 8 and 16,
     12,954,816 train rays; llff_z_plane (bf16) with the loader's
     dataset_info trained 60 steps from the in-memory batch_iterator (the
     loss falls); view 8 through model.apply on the quad route (K1, K5
     once per chunk), its ms and PSNR; on one chunk K1 and K5 against their
     plain versions (the gates of phase 60);
 66. the ray store alone on 64's rays: gather of 4,096 seeded indices
     equal to the in-memory rows to the bit; one seed and thread count
     give one batch twice, another seed another;
 67. the flagship trained through the CLI, in this process
     (hyperreel_tpu_torch.main.main): a YAML config (64's scene, the ray
     store, bf16, tv_4000) and dotted overrides that move the alpha event
     and the first upsample into the run and sort invalid samples far (so
     that the viewer can compact); CLI_EPOCHS epochs of CLI_ITERS
     steps, validated after each (the held-out PSNR printed), the step's
     ms (CUDA events), metrics.jsonl and the `last` checkpoint; the loss
     falls, every param is finite;
 68-70. one CLI call with --resume on that checkpoint, --eval-only (every
     held-out image through the Renderer, PNGs, psnr and ssim),
     --render-only (the 30-frame spiral at 2048 x 1088, its PNGs and mp4)
     and --export-mesh (128^3 density grid, marching tetrahedra): the
     launches of the whole call are K1 and K2 only, 9 each per image;
     then one view's launches (9 + 9), its ms, and its first chunk's K1
     and K2 against their plain versions (K1 under the f32 MLP policy at
     PACK_TOL, and under bf16 by pack row: bf16_colour_gate); the
     numbers are what main.main returns;
 71. the viewer on the trained flagship: InteractiveRenderer at base 512^2
     and 1024^2, full quality and with compaction 16 (fast_mode_probe's dB
     printed), and the coherent-gather clone (which ladder levels pass
     the patch gate): per level the device ms (CUDA events), the wall ms
     from submit to read and the launches per frame; a full-quality
     1024^2 frame within 1 uint8 level of the Renderer's render of the
     same pose;
 72. the viewer's HTTP server on 127.0.0.1 and a free port in a thread:
     GET / and three GET /frame requests, each a PNG of the ladder level's
     size with an X-Frame-Time header; then shut down;
 73. llff_z_plane trained through the CLI on 65's scene with the
     epipolar and focus visualizers in the config, then --eval-only on its
     checkpoint: the launches K1 and K5 only, the visualizers' images
     written; on the first held-out view K1 and K5 against their plain
     versions;
 74. data parallelism (hyperreel_tpu_torch/parallel/mesh.py): this
     process joins a process group of one rank over NCCL and the flagship
     (bf16) trains DP_STEPS steps through System.fit with
     training.data_parallel=true on the blob scene (ShardedTrainer, the
     all-reduce included), validated and checkpointed; the sharded step's
     ms (CUDA events);
 75. two ranks over NCCL on the one card (`chip_smoke.py --nccl-probe`
     subprocesses): NCCL refuses them (printed, with its message);
 76. two ranks over gloo on cuda:0 (`chip_smoke.py --dp-worker`
     subprocesses; gloo's all-reduce and broadcast on tensors on the card
     probed): DP_STEPS steps of the flagship (f32 MLP and tables, the
     flow jitter on: a per-ray draw) on 16,384-ray global batches from
     one set of weights, against one process on the same batches and
     draws: the first step's averaged gradients per leaf (DP_GRAD_TOL),
     the params after the steps (DP_PARAM_TOL of the distance they moved,
     L2; a run without rank 1's rows must be 10x further off), both
     ranks equal to the bit; ms/step of each rank and of one process;
 77-79. technicolor_cascaded (bf16) trained through the CLI on CASC_FRAMES
     frames of 64's scene, CASC_EPOCHS epochs of CASC_ITERS steps with
     its alpha event and first upsample moved into the run: the loss
     falls, the validations launch K2 only (9 per image), the step's ms,
     the peak of allocated memory, the held-out views' PSNR; a held-out
     view through the Renderer (its ms, PSNR, 9 K2 launches); on its
     first chunk K2 (the time plane, the predicted colour scale and
     shift) against its plain version and the own route against the
     general colour net, K2's time and bound;
 80-81. blender_voxel (bf16, 192 samples, softplus, white background) on
     a Blender-layout scene written at the published 800 x 800
     (BLENDER_TRAIN train and BLENDER_VAL val views): BLENDER_STEPS steps
     across its alpha event moved to BLENDER_ALPHA_IT, the step's ms and
     peak memory; a held-out view through the Renderer at BLENDER_CHUNK
     rays a chunk (the general chain: no kernel), its ms, PSNR, peak
     memory and the device's idle share over one chunk;
 82. refnerf_sphere_reflect and refnerf_sphere on the Blender scene, and
 83. shiny_z_deformable on 65's LLFF scene: FAMILY_STEPS steps, then a
     held-out view through the general chain and K5 (RGB, the weights
     row; once per chunk, nothing else), its first chunk's K5 against its
     plain version and the own route against the general colour net;
 84. at SH degrees 0, 1, 3 and 4 (data_dim_color 3, 12, 48, 75; the
     basis redrawn): the flagship's chunk through model.apply on its quad
     (K1, K2), fused patch (K3) and two-kernel (K4, K2-pre) routes, then
     K2, K2-preblended and K3 on the chunk's pack against their plain
     versions (<= 1e-4 on rgb/acc), timed, with their bounds at that
     degree;
 85. the same for llff_z_plane's chunk (checkpoint grid): K5, K5-pre, K6;
 86. the bench frame of the flagship at SH 3 (quad, fused, two-kernel;
     the own route on a chunk against the general colour net) and of
     llff_z_plane at SH 4 (quad, fused, two-kernel): launches, the patch
     routes within 2e-4 of the quad route where the witness passes, the
     quad route within 2e-4 of the general path on 4096 rays (f32 MLP),
     each frame's ms beside degree 2's;
 87. the flagship with a color_transform stage trained through the CLI
     (CT_ITERS steps) on a 4 x 4 rig at CT_WH whose cameras' images carry
     colour gains: the learned per-camera gains against them (relative to
     the rig's mean), held-out rays through the own route (K2, then the
     global transform) within 2e-4 of the general colour net;
 88-89. neural_3d_z_plane with DensityFourier and RGBtFourier, the
     flagship with MLP_Fea: HEAD_STEPS steps and an eval chunk each (the
     general chain);
 90. tensor_vm (8, 24) and tensor_cp (96, 288) on the llff chain at a
     128^3 grid: steps, an upsample to 160^3, steps (ms each);
 91. the standalone tensor_vm_split march: steps, an upsample, steps;
 92. K1 on the flagship's first bench chunk at each layer activation
     that it takes (LAYER_ACTS: identity, sigmoid, tanh, softplus, relu,
     leaky_relu, abs, zero, identity_tanh, an ease_value and an
     interp_value at weight 0.5), under the bf16 and f32 MLP policies,
     against its plain version, timed; the chunk through model.apply (K1
     and K2 once);
 93. the same with the field activations of FIELD_GROUPS on the z,
     isect, sigma, flow, flow-stage, point-sigma, offset, offset-stage and
     colour slots (every elementwise kind, an ease_value and an
     interp_value);
 94. the same at 48 and 96 encoded columns (wider PEs);
 95. the long-tail flagship (longtail_cfg: pluecker with use_local_param
     and a windowed_random PE, a random time PE, relu layers,
     identity_tanh offsets, an interp_value flow) trained LT_ITERS steps
     through the CLI, a held-out view through the Renderer on the quad
     and fused patch routes, its PSNR above the untrained view's, K1 and
     K2 against their plain versions, fused against the general chain;
 96. neural_3d_z_plane with an angular flow and ray outputs through the
     general chain (an eval chunk, a step), and every ray param of the
     registry on llff_z_plane (an eval chunk each).
The line before the last is the kernels' JSON record (launches on their
main path, error against the plain version, ms and the plain version's
ms, and the least time the card could take, counting of each table only
the rows the chunk reads); the last line is
{"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import re
import subprocess
import time

import numpy as np

SEED = 0
IT = 20000                     # past every ease window of the flagship
CHUNK = 1 << 18                # bench.py:103
SIDE = 1 << 10                 # 1024^2 frame, bench.py:104-115
FRAME_T = 0.3
TIMED_FRAMES = 10
PATCH_R8 = (5, 2, 8)           # bench.py's route: (px, py), R (:62-70)
PATCH_R4 = (4, 3, 4)
PVIOL_EXACT = 1e-4             # bench.py:159
# K1 under the f32 policy: the same f32 math, sums in another order
PACK_TOL = 1e-5
# K1 under the bf16 policy: both sides round the same operands and sum
# exact products in f32 in another order; a hidden value on the other
# side of a bf16 rounding boundary moves one bf16 ulp (2^-8 relative)
# into the next layer, which moves points and distances by up to ~1e-3
PACK_TOL_BF16 = 2e-3
# K1 under the bf16 policy on trained weights (bf16_colour_gate): the share
# of samples whose colour fields may move more than 1e-3 (measured 0.022 %
# after 600 steps) and the most any colour field may move, in bf16 ulps
BF16_MOVED_SHARE = 1e-3
BF16_COLOUR_ULPS = 4
# K1 against its plain version on a trained model whose camera sits among
# the planes: the share of rays on which the two may disagree about a
# sample within rounding of distance 0, each such ray held shifted by the
# flipped samples (sentinel_flips)
FLIP_SHARE = 1e-3
SHADE_TOL = 1e-4               # another order of the per-ray warp sums
PATH_TOL = 2e-4                # tests/test_fused_cf.py gate
COMPOSITE_TOL = 1e-5           # f32 scan and sums in another order
F32_RAYS = 16384               # K1's f32-policy check (plain FMA layers)
COMPOSITE_S = 32
# llff_z_plane's density planes and lines are redrawn uniform in [0, this)
LLFF_DENSITY = 0.05
# shiny_z_plane's and stanford_llff_z_plane's (their acc mean on the bench
# frame ~0.92 and ~0.93, measured on the CPU at a small grid)
SHINY_DENSITY = 0.2
STANFORD_DENSITY = 0.3
# neural_3d_z_plane: its density grids redrawn uniform in [0, this); the
# JAX test's patch candidate (tests/test_fused_cf.py:1100-1107) and the
# shape that keeps llff_z_plane's frame inside its patches
N3D_DENSITY = 0.05
N3D_PATCH_R8 = (5, 3, 8)
N3D_PATCH_R4 = (4, 3, 4)
N3D_TIMED_FRAMES = 5
# K6's times per chunk before its thread-per-ray redesign (the
# block-prologue kernel), as this script measured them on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md section 6): the reference each new time is
# printed against
BEFORE_MS = {"llff K6": 1.125, "shiny K6": 0.929, "n3d K6 R=8": 3.236,
             "n3d K6 R=4": 5.037, "n3d_stride16 K6": 0.691,
             "shiny_compact16 K6": 0.488}

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): device
# memory bytes/s, f32 operations/s outside the tensor cores, dense bf16
# tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# f32 operations counted from the kernels' sources (csrc/), per sample:
# K1's tail after the MLP (field activations, z and distance, the
# 32-lane sort's compare-exchanges, advection, offsets, normalisation);
# K2/K3's shading of a valid sample after its space features (time taps
# 4C+6, the space x time product C, density nd, basis 54C, SH basis 20,
# SH sums 54, colour 12, validity 8); the bilinear quad blend (8C+10) and
# K3/K4's hat blend of at most four texels (8C+22); the composite of one
# sample with its 5 sums (46) or K7's 4 (40).
K1_TAIL_OPS = 100
# K1's mipnerf contraction per sample: inverse_contract_distance (8),
# contract_rows of the point and of the origin (2 x 20), the distance (9)
K1_CONTRACT_OPS = 57
COMPOSITE_OPS, COMPOSITE4_OPS = 46, 40


def n3d_info():
    """neural_3d_z_plane's dataset_info: the port's Neural 3D loader's
    published window (50 frames, a keyframe every 4: 12 keyframes)."""
    from hyperreel_tpu_torch.data.neural_3d import window_info
    return window_info()


def shade_ops(C, nd, rgb=False, weights=False, fold=None, nb=9):
    """K2/K3's f32 operations per valid sample after its space features:
    time taps 4C+6, the product C, density nd (and the weight), the colour
    of the C features (`colour_ops`, SH with nb bases), validity 8."""
    return 5 * C + nd + 14 + colour_ops(C, rgb, fold, nb) + int(weights)


# the bounds of the SH rows by both counts of the colour (sh_bound): name
# -> (bound ms with the basis folded per ray, bound ms without)
SH_BOUNDS = {}


def sh_bound(name, nbytes, ops, S):
    """bound(nbytes, ops(S)), the least work with the SH basis folded once
    per ray over its S samples; the bound by the count without the fold,
    ops(None), is kept beside it in SH_BOUNDS where the two differ."""
    new = bound(nbytes, ops(S))
    old = bound(nbytes, ops(None))[0]
    if old != new[0]:
        SH_BOUNDS[name] = (new[0], old)
    return new


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates; ops = [(count, peak)]."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / peak for n, peak in ops)
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def rows_bytes(table, rows):
    """Bytes of the rows of a [n, width] table that the flat row indices
    `rows` touch, each row counted once."""
    return rows.unique().numel() * table.shape[1] * table.element_size()


def ray_bytes(rp, rgb, timed):
    """Bytes of the ray pack [B, 8] that a shade kernel reads: the view
    direction for SH colour, the time for a time plane; a static net with
    RGB colour reads none of it (csrc/shade_core.cuh colour, shade_sample;
    multi_core.cuh shade_axes)."""
    return 0 if rgb and not timed else nbytes(rp)


def pack_bytes(pack, valid):
    """Bytes of the pack that a shade kernel reads: its 10 rows for every
    sample and, in a pack with the weights row, that row only for the
    `valid` samples (csrc/shade.cu, shade_multi.cu load it under the
    validity test)."""
    from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS
    return nbytes(pack[:PACK_ROWS]) + (pack.shape[0] - PACK_ROWS) * valid * 4


def quad_rows(pack, m0, m1, W, H):
    """The quad-table rows that the valid samples of `pack` read on the
    plane of pack rows (m0, m1) (csrc/shade_core.cuh, multi_core.cuh)."""
    from hyperreel_tpu_torch.ops.kernels.shade import taps
    ok = valid_mask(pack)
    xi, yi = taps(pack[m0][ok], W)[0], taps(pack[m1][ok], H)[0]
    return (yi + 1) * (W + 1) + (xi + 1)


def patch_rows(pack, spec, every_slot):
    """The patch-table rows of the slots' anchors (patch_anchor_idx): of
    every slot (K4 writes every sample's features), or only of the slots
    with a valid sample (the fused kernels shade nothing else)."""
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        grouped, patch_anchors)
    rows = patch_anchors(pack, spec)[2]
    return rows if every_slot else rows[grouped(valid_mask(pack),
                                                spec).any(0)]


def entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
    """One kernel's record in the JSON line (no single PyTorch call
    computes any of these functions, so there is no library time)."""
    return {"name": name, "route": "cuda",
            "source": f"hyperreel_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of fn over `reps` calls after one
    warm-up call, from CUDA events."""
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


def build_stats(kernel, args):
    """'blocks of 128 threads, <r> registers, <s>/<l> bytes of spill
    stores/loads' of one instantiation of K6 (shade_multi_patch_kernel;
    args R, kTime, kRgb) or K5-preblended (shade_multi_pre_kernel; args
    samples per lane, kTime, kRgb) at the [8, 4, 4] layout, from the
    build's ptxas output."""
    from hyperreel_tpu_torch.ops.kernels import build
    # the last template argument: the degree-2 instantiation (kAnyDeg)
    want = (16, 8, 8, 4, 8, 4) + tuple(int(a) for a in args) + (0,)
    found = False
    for line in build.load_library().compiler_log.splitlines():
        m = re.search(r"\d([a-z_]+_kernel)I(\w+?)EEv", line)
        if "Compiling entry" in line and m:
            toks = tuple(int(x) for x in re.findall(r"L[ib](\d+)E", m[2]))
            found = m[1] == kernel and toks == want
        elif found and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes", line)[1:3]
        elif found and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            return (f"blocks of 128 threads, {regs} registers, "
                    f"{spill[0]}/{spill[1]} bytes of spill stores/loads")
    return "no ptxas record"


def folded_errs(out, ref):
    """max |kernel - folded plain| of rgb/acc and of depth."""
    return ((out[:, :4] - ref[:, :4]).abs().max().item(),
            (out[:, 4] - ref[:, 4]).abs().max().item())


def k1_plan(torch, name, cf, tabs, mlp_ops, k1_ms):
    """K1's plan and yardsticks on one chunk, printed: its rays per block,
    the bytes of weight slabs that the chunk's tiles read from L2 (every
    tile reads them once), the MLP's TFLOP/s at K1's time, and the six
    bf16 torch.matmul calls at the chunk's shapes (cuBLAS: a yardstick that
    the port never calls, without K1's tail)."""
    from hyperreel_tpu_torch.ops.kernels import build

    rpb = build.load_library().lib.pack_rays_per_block(
        cf.spec.params(CHUNK, tabs, IT))
    l2 = -(-CHUNK // rpb) * nbytes(tabs.tiled)
    gen = torch.Generator(device=tabs.tiled.device).manual_seed(SEED)
    mats = [(torch.randn(CHUNK, l.w.shape[0], device=l.w.device,
                         generator=gen).to(torch.bfloat16), l.w)
            for l in tabs.layers]
    mm_ms = cuda_ms(torch, lambda: [a @ w for a, w in mats], 10)
    print(f"# {name} K1 plan: {rpb} rays per block, "
          f"{nbytes(tabs.tiled) / 1e6:.3f} MB of weight slabs per tile, "
          f"{l2 / 1e9:.3f} GB per chunk from L2; MLP {mlp_ops / 1e9:.1f} "
          f"GFLOP at {mlp_ops / k1_ms / 1e9:.1f} TFLOP/s of K1's {k1_ms:.3f} "
          f"ms; yardstick: the six bf16 torch.matmul at the chunk's shapes "
          f"{mm_ms:.3f} ms ({mlp_ops / mm_ms / 1e9:.1f} TFLOP/s)", flush=True)
    del mats
    torch.cuda.empty_cache()


def bench_frame():
    """bench.py's 1024^2 pinhole frame: o = (0, 0, -1.5), unit-z
    directions, camera 3, t = 0.3; [4, 262144, 8] f32."""
    n = SIDE * SIDE
    u = (np.arange(SIDE, dtype=np.float32) - (SIDE - 1) / 2) / (SIDE * 1.2)
    uu, vv = np.meshgrid(u, u)
    d = np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3)
    o = np.zeros_like(d)
    o[:, 2] = -1.5
    cam = np.full((n, 1), 3.0, np.float32)
    t = np.full((n, 1), FRAME_T, np.float32)
    return np.concatenate([o, d, cam, t], -1).astype(np.float32).reshape(
        n // CHUNK, CHUNK, 8)


def phase_major(chunks, R):
    """bench.py:125-127, per chunk of a [k, chunk, D] tensor: original ray
    R*j+p at position p*(chunk/R)+j."""
    k, n, D = chunks.shape
    return chunks.reshape(k, n // R, R, D).transpose(1, 2).reshape(k, n, D)


def scanline(chunk_out, R):
    """Per-ray outputs [chunk, D] of phase-major rays -> scanline order."""
    n, D = chunk_out.shape
    return chunk_out.reshape(R, n // R, D).transpose(0, 1).reshape(n, D)


def entry_rays(n):
    """__graft_entry__.entry()'s random rays (numpy seed 0)."""
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] -= 1.5
    d = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d[:, 2] = 1.0
    cam = rng.integers(0, 16, (n, 1)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    return np.concatenate([o, d, cam, t], -1)


def flagship(dev):
    """technicolor_z_plane at full width under the bf16 MLP policy, with
    weights from torch.Generator seed SEED: (cfg, dataset_info, model,
    params, prepared tables)."""
    import torch

    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, technicolor_z_plane)
    from hyperreel_tpu_torch.models.model import build_model

    cfg = convert_epochs_to_iters(technicolor_z_plane(), iters_per_epoch=4000)
    info = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
    model = build_model(cfg, dataset_info=info, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED)
    params = model.init(gen, dev)
    # the relu init of the density grids is a constant 1e-2 (an almost
    # transparent scene); redraw them uniform in [0, 0.3) so that rays
    # end partly opaque and the composite is exercised
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = 0.3 * torch.rand(
            v.shape, generator=gen).to(dev)
    return cfg, info, model, params, model.prepare_eval(params)


# the static z-plane families: their presets and the bound their density
# planes and lines are redrawn uniform below (llff_z_plane: acc mean 0.995
# on the bench frame; shiny_z_plane: ~0.92, a forward-facing scene whose
# rays end mostly opaque); llff and shiny take the channels-first route,
# stanford_llff_z_plane its net's own fused route
STATIC = {"llff": ("llff_z_plane", LLFF_DENSITY),
          "shiny": ("shiny_z_plane", SHINY_DENSITY),
          "stanford": ("stanford_llff_z_plane", STANFORD_DENSITY)}


def static_model(dev, family="llff", bf16=True, patch=None, params=None,
                 grid="checkpoint"):
    """llff_z_plane (6x256 MLP on pluecker rays, mipnerf contraction) or
    shiny_z_plane (6x256 MLP on two-plane rays, identity contraction, RGB
    colour) at full width, S=32, [8, 4, 4] components, or
    stanford_llff_z_plane (as shiny, one plane x line axis [8, 0, 0]), on
    a trained checkpoint's grid: N_voxel_init set to N_voxel_final
    (262,144,000 voxels; llff: planes 786x706, 471x706, 471x786, lines
    471, 786, 706; shiny: planes 806x806, 403x806, 403x806, lines 403,
    806, 806; stanford: 512,000,000 voxels, the plane 1007x1007, the line
    503), so that the bf16 quad tables (~116 / ~125 / ~130 MB) exceed the
    50 MB L2; with grid="init" the preset's own N_voxel_init (128^3
    voxels, a few MB of tables, which stay in L2). The bf16 (or f32) MLP
    policy; with `patch` the coherent patch-gather route (px, py, R).
    Weights from torch.Generator seed SEED (or the given params) with the
    density planes and lines redrawn uniform in [0, STATIC[family][1]):
    (cfg, model, params, prepared tables)."""
    import torch

    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.models.model import build_model

    preset, density = STATIC[family]
    cfg = presets.convert_epochs_to_iters(getattr(presets, preset)(),
                                          iters_per_epoch=4000)
    net = cfg["color"]["net"]
    if grid == "checkpoint":
        net["N_voxel_init"] = net["N_voxel_final"]
    if patch:
        cfg = presets.with_coherent_gather(cfg, *patch)
    model = build_model(cfg, compute_dtype=torch.bfloat16 if bf16 else None)
    if params is None:
        gen = torch.Generator().manual_seed(SEED)
        params = model.init(gen, dev)
        # the relu init of the density grids is a constant 1e-2 (an almost
        # transparent scene); redrawn, the bench frame's rays end mostly
        # opaque over several samples
        for k, v in params["color"]["density"].items():
            params["color"]["density"][k] = density * torch.rand(
                v.shape, generator=gen).to(dev)
    return cfg, model, params, model.prepare_eval(params)


def valid_mask(pack):
    """Samples inside the aabb with a positive distance."""
    return ((pack[0].abs() <= 1) & (pack[1].abs() <= 1)
            & (pack[2].abs() <= 1) & (pack[3] > 0))


def valid_count(pack):
    return valid_mask(pack).sum().item()


# f32 operations of the nb SH bases of one view direction (csrc/
# shade_core.cuh sh_basis: degree 0-4, nb = 1, 4, 9, 16, 25)
SH_BASIS_OPS = {1: 0, 4: 3, 9: 20, 16: 50, 25: 90}


def colour_ops(A, rgb, fold=None, nb=9):
    """f32 operations of one valid sample's colour from A features: RGB
    (the basis 6A, the sigmoids 12, colour 12); SH with nb bases (degree
    2: 9) with `fold` = S, the least work for the function: the [3 nb, A]
    basis folded with the ray's view direction once per ray (6 nb A, and
    its SH bases, SH_BASIS_OPS), spread over the ray's S samples, then a
    [3, A] product (6A) and the colour 12 per sample; with fold None the
    count without the fold (the basis 6 nb A, the SH bases, SH sums 6 nb,
    colour 12)."""
    if rgb:
        return 6 * A + 24
    if fold:
        return 6 * A + 12 + (6 * nb * A + SH_BASIS_OPS[nb]) / fold
    return 6 * nb * A + SH_BASIS_OPS[nb] + 6 * nb + 12


def multi_ops(axes, blend, rgb=False, weights=False, fold=None, nb=9):
    """f32 operations per valid sample after the pack of K5/K6: per axis
    the plane features (`blend(C)`), the second factor (a line's taps
    4C+6; a time plane's z and t taps and its two rows' blends and mix
    12C+12), the product (C) and the density sum (nd), then the weight
    (1, with the weights row), the colour of the A appearance channels,
    validity 8."""
    A = sum(a.C - a.nd for a in axes)
    return sum(blend(a.C) + (12 * a.C + 12 if a.TH else 4 * a.C + 6) + a.C
               + a.nd for a in axes) + colour_ops(A, rgb, fold, nb) \
        + int(weights) + 8


def k5_launch(shade_multi):
    """The persistent grid K5's last launch chose
    (ops/kernels/shade_multi.py `shade_multi.last_launch`)."""
    lc = shade_multi.last_launch
    return (f"grid {lc['grid']} ({lc['blocks_per_sm']} blocks of 256 per "
            f"SM), carve-out {lc['carveout']} %, {lc['smem_bytes']} bytes "
            f"of shared memory per block")


def static_phases(torch, dev, card, frame, reset_counts, read_counts,
                  family):
    """Phases 9-13 (llff_z_plane) or 19-23 (shiny_z_plane): the family's
    kernels on one chunk against their plain versions and timed in turns,
    the bench frame on its routes, fused vs general path, and the routes'
    frame times; for shiny also K5 with the weights row, and the frame
    through the net's own fused route. Returns (the kernels' JSON records,
    {route: ms/frame})."""
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        pack_build, pack_build_plain)
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        patch_blend, patch_blend_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        MultiSpec, shade_multi, shade_multi_plain, shade_multi_preblended,
        shade_multi_preblended_folded_plain, shade_multi_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
        shade_multi_patch, shade_multi_patch_folded_plain,
        shade_multi_patch_plain)

    ctx = StepCtx(it=IT)
    # ---- 9. the model at the checkpoint grid, quad and patch routes
    cfg, model, params, prep = static_model(dev, family)
    _, model8, _, prep8 = static_model(dev, family, patch=PATCH_R8,
                                       params=params)
    cf = model._cf_eval
    rgb_colour = cf.net.shading == "rgb"
    axes = prep["axes"]
    timed = any(a.TH for a in axes)
    print(f"# {STATIC[family][0]}: planes " + ", ".join(
        f"{a.H}x{a.W}x{a.C}" for a in axes) + "; lines " + ", ".join(
        str(a.L) for a in axes) + f"; quad tables "
        f"{sum(nbytes(q) for q in prep['quads']) / 1e6:.1f} MB", flush=True)
    frame6 = frame[..., :6].contiguous()      # a static scene: o, d only
    R8 = PATCH_R8[2]
    frame_pm = phase_major(frame6, R8).contiguous()

    # ---- 10. one chunk: K1 (contraction, no flow) and K5 against their
    # plain versions; K4 on each plane, K5-preblended and K6 on the chunk
    # in bench.py's phase-major order
    chunk, chunk_pm = frame6[0], frame_pm[0]
    net_in = cf.pred.net_input(chunk, ctx).float().contiguous()
    rp = cf.ray_pack(chunk)
    tabs = prep["mlp"]
    pack = pack_build(net_in, tabs, rp, cf.spec, IT)
    pack_p = pack_build_plain(net_in, tabs, rp, cf.spec, IT)
    torch.cuda.synchronize()
    k1_err = (pack - pack_p).abs().max().item()
    cf32 = static_model(dev, family, bf16=False, params=params)[1]._cf_eval
    tabs32 = cf32.prepare(params)["mlp"]
    x32, rp32 = net_in[:F32_RAYS].contiguous(), rp[:F32_RAYS].contiguous()
    k1_err32 = (pack_build(x32, tabs32, rp32, cf32.spec, IT)
                - pack_build_plain(x32, tabs32, rp32, cf32.spec, IT)
                ).abs().max().item()
    print(f"# {family} K1 pack_build ({cf.spec.contract.name} "
          f"contraction, no flow): max |kernel - plain| {k1_err:.3e} bf16 "
          f"MLP (tol {PACK_TOL_BF16}), {k1_err32:.3e} f32 MLP on "
          f"{F32_RAYS} rays (tol {PACK_TOL})", flush=True)
    if not (k1_err <= PACK_TOL_BF16 and k1_err32 <= PACK_TOL):
        raise AssertionError(f"{family} K1 disagrees with its plain version: "
                             f"{k1_err}, {k1_err32}")
    del pack_p
    N = pack.shape[1]
    valid = valid_count(pack)
    print(f"# {family} chunk: {valid} of {N} samples valid "
          f"({100 * valid / N:.1f} %)", flush=True)
    if valid < N // 4:
        raise AssertionError("under a quarter of the samples are valid: "
                             "move the camera")

    spec = MultiSpec(S=cf.S, axes=axes, deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale,
                     shading=cf.net.shading)
    lines, wb = prep["lines"], prep["wb"]
    out = shade_multi(prep["quads"], lines, pack, rp, wb, spec)
    out_p = shade_multi_plain(prep["quads"], lines, pack, rp, wb, spec)
    torch.cuda.synchronize()
    k5_err = (out[:, :4] - out_p[:, :4]).abs().max().item()
    k5_derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
    print(f"# {family} K5 shade_multi ({cf.net.shading}): max |kernel - "
          f"plain| rgb/acc {k5_err:.3e}, "
          f"depth {k5_derr:.3e} (tol {SHADE_TOL}); acc mean "
          f"{out[:, 3].mean().item():.4f}; {k5_launch(shade_multi)}",
          flush=True)
    if not (k5_err <= SHADE_TOL and k5_derr <= 10 * SHADE_TOL):
        raise AssertionError(f"K5 disagrees with its plain version: "
                             f"{k5_err}, {k5_derr}")
    del out_p
    if family == "shiny":
        # K5 with the weights row (the net's own fused route's pack) on the
        # same samples, the weights drawn uniform in [0, 2)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        pack_w = torch.cat([pack, 2 * torch.rand(1, N, device=dev,
                                                 generator=gen)])
        wspec = dataclasses.replace(spec, weights=True)
        out_w = shade_multi(prep["quads"], lines, pack_w, rp, wb, wspec)
        out_wp = shade_multi_plain(prep["quads"], lines, pack_w, rp, wb,
                                   wspec)
        torch.cuda.synchronize()
        k5w_err = (out_w[:, :4] - out_wp[:, :4]).abs().max().item()
        k5w_derr = (out_w[:, 4] - out_wp[:, 4]).abs().max().item()
        k5w_ms = cuda_ms(torch, lambda: shade_multi(
            prep["quads"], lines, pack_w, rp, wb, wspec), 20)
        k5w_plain_ms = cuda_ms(torch, lambda: shade_multi_plain(
            prep["quads"], lines, pack_w, rp, wb, wspec), 2)
        k5w_bound = bound(
            pack_bytes(pack_w, valid) + ray_bytes(rp, rgb_colour, timed)
            + nbytes(*lines) + CHUNK * 5 * 4 + sum(
                rows_bytes(q, quad_rows(pack, a.m0, a.m1, a.W, a.H))
                for q, a in zip(prep["quads"], axes)),
            [(valid * multi_ops(axes, lambda C: 8 * C + 10, rgb_colour,
                                    True)
              + N * COMPOSITE_OPS, F32_OPS_PER_S)])
        print(f"# {family} K5 shade_multi ({cf.net.shading}, weights row): "
              f"max |kernel - plain| rgb/acc {k5w_err:.3e}, depth "
              f"{k5w_derr:.3e} (tol {SHADE_TOL}); {k5w_ms:.3f} ms (plain "
              f"{k5w_plain_ms:.3f}, bound {k5w_bound[0]:.4f} "
              f"{k5w_bound[1]})", flush=True)
        if not (k5w_err <= SHADE_TOL and k5w_derr <= 10 * SHADE_TOL):
            raise AssertionError(f"K5 with the weights row disagrees with "
                                 f"its plain version: {k5w_err}, {k5w_derr}")
        del pack_w, out_w, out_wp

    rp_pm = cf.ray_pack(chunk_pm)
    pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                         .contiguous(), tabs, rp_pm, cf.spec, IT)
    cf8 = model8._cf_eval
    pspecs = cf8.patch_specs([(a.W, a.H, a.C, a.m0, a.m1) for a in axes],
                             True)
    feats, viol_k4, k4_err = k4_check(torch, family, prep8["ptabs"], pack_pm,
                                      pspecs)
    pre = shade_multi_preblended(feats, lines, pack_pm, rp_pm, wb, spec)
    pre_p = shade_multi_preblended_plain(feats, lines, pack_pm, rp_pm, wb,
                                         spec)
    fused, vk = shade_multi_patch(prep8["ptabs"], lines, pack_pm, rp_pm, wb,
                                  spec, pspecs)
    fused_p, vp = shade_multi_patch_plain(prep8["ptabs"], lines, pack_pm,
                                          rp_pm, wb, spec, pspecs)
    quad_pm = shade_multi(prep["quads"], lines, pack_pm, rp_pm, wb, spec)
    torch.cuda.synchronize()
    pre_err = (pre[:, :4] - pre_p[:, :4]).abs().max().item()
    k6_err = (fused[:, :4] - fused_p[:, :4]).abs().max().item()
    k6_derr = (fused[:, 4] - fused_p[:, 4]).abs().max().item()
    print(f"# K5-preblended: max |kernel - plain| {pre_err:.3e} (tol "
          f"{SHADE_TOL}); K6 shade_multi_patch R=8 (5,2): rgb/acc "
          f"{k6_err:.3e}, depth {k6_derr:.3e} (tol {SHADE_TOL}); coverage "
          f"violations K6 {int(vk)}, plain {int(vp)}, K4 {viol_k4} of "
          f"{N // R8} slots; K6 vs K5 "
          f"{(fused[:, :4] - quad_pm[:, :4]).abs().max().item():.3e}, "
          f"K4 + K5-pre vs K5 "
          f"{(pre[:, :4] - quad_pm[:, :4]).abs().max().item():.3e}",
          flush=True)
    if not (pre_err <= SHADE_TOL and k6_err <= SHADE_TOL
            and k6_derr <= 10 * SHADE_TOL
            and int(vk) == int(vp) == viol_k4):
        raise AssertionError(f"K5-preblended / K6 disagree with their plain "
                             f"versions: {pre_err}, {k6_err}, {k6_derr}, "
                             f"{int(vk)}, {int(vp)}, {viol_k4}")
    # each also against its folded plain version (the kernels' op order)
    pre_f = folded_errs(pre, shade_multi_preblended_folded_plain(
        feats, lines, pack_pm, rp_pm, wb, spec))
    fused_f, vf = shade_multi_patch_folded_plain(
        prep8["ptabs"], lines, pack_pm, rp_pm, wb, spec, pspecs)
    k6_f = folded_errs(fused, fused_f)
    print(f"# {family} K5-preblended vs its folded plain version: rgb/acc "
          f"{pre_f[0]:.3e}, depth {pre_f[1]:.3e}; "
          + build_stats("shade_multi_pre_kernel", (1, timed, rgb_colour))
          + ". "
          f"K6 R=8 (5,2) vs its folded plain version: rgb/acc "
          f"{k6_f[0]:.3e}, depth {k6_f[1]:.3e}, violations {int(vf)}; "
          + build_stats("shade_multi_patch_kernel", (R8, timed, rgb_colour)),
          flush=True)
    if not (max(pre_f[0], k6_f[0]) <= SHADE_TOL
            and max(pre_f[1], k6_f[1]) <= 10 * SHADE_TOL
            and int(vf) == int(vk)):
        raise AssertionError(f"K5-preblended / K6 disagree with their "
                             f"folded plain versions: {pre_f}, {k6_f}, "
                             f"{int(vf)}, {int(vk)}")
    del pre_p, fused_p, fused_f

    # the chunk's kernels, timed in turns (K5, K5 scanline, K6, K4 x3,
    # K5-pre, and back), 20 calls each time; then each plain version once
    # or twice. The kernels on the phase-major chunk, as the patch routes
    # give it; K5 also on the chunk in scanline order, as the quad route
    # gives it (its warps take neighbouring rays). The same rays: the
    # bounds below count the same samples and rows for both orders.
    def blend3():
        return patch_blend(prep8["ptabs"], pack_pm, pspecs)

    kernels = {
        "K5": lambda: shade_multi(prep["quads"], lines, pack_pm, rp_pm, wb,
                                  spec),
        "K5 scanline": lambda: shade_multi(prep["quads"], lines, pack, rp,
                                           wb, spec),
        "K6": lambda: shade_multi_patch(prep8["ptabs"], lines, pack_pm,
                                        rp_pm, wb, spec, pspecs),
        "K4x3": blend3,
        "K5-pre": lambda: shade_multi_preblended(feats, lines, pack_pm,
                                                 rp_pm, wb, spec)}
    turns = {name: [] for name in kernels}
    for name in list(kernels) + list(kernels)[::-1]:
        turns[name].append(cuda_ms(torch, kernels[name], 20))
    print(f"# {family} chunk, in turns: " + "; ".join(
        f"{name} " + ", ".join(f"{t:.4f}" for t in ts) + " ms"
        for name, ts in turns.items()), flush=True)
    k5_ms, k5_scan_ms, k6_ms, k4_ms, pre_ms = (sum(turns[n]) / 2
                                               for n in kernels)
    if family == "llff":
        # K5 on the same pack with the tables of the preset's init grid
        # (N_voxel_init: ~4.7 MB of quad tables, which stay in L2), in turns
        # with the checkpoint grid's: how much of K5's time the quad-row reads
        # from device memory cost
        _, small, small_params, _ = static_model(dev, "llff", grid="init")
        sprep = small.prepare_eval(small_params)
        sspec = MultiSpec(S=cf.S, axes=sprep["axes"], deg=cf.net.sh_deg,
                          distance_scale=cf.net.distance_scale)
        grids = {
            "checkpoint": lambda: shade_multi(prep["quads"], lines, pack_pm,
                                              rp_pm, wb, spec),
            "init": lambda: shade_multi(sprep["quads"], sprep["lines"],
                                        pack_pm, rp_pm, sprep["wb"], sspec)}
        gturns = {name: [] for name in grids}
        for name in list(grids) + list(grids)[::-1]:
            gturns[name].append(cuda_ms(torch, grids[name], 20))
        print(f"# K5 by grid, in turns: checkpoint grid ("
              f"{sum(nbytes(q) for q in prep['quads']) / 1e6:.1f} MB of quad "
              f"tables) " + ", ".join(f"{t:.4f}" for t in gturns["checkpoint"])
              + f" ms; init grid ("
              f"{sum(nbytes(q) for q in sprep['quads']) / 1e6:.1f} MB) "
              + ", ".join(f"{t:.4f}" for t in gturns["init"]) + " ms",
              flush=True)
        del small, small_params, sprep
    k1_ms = cuda_ms(torch, lambda: pack_build(net_in, tabs, rp, cf.spec, IT),
                    20)
    k1_plain_ms = cuda_ms(
        torch, lambda: pack_build_plain(net_in, tabs, rp, cf.spec, IT), 2)
    k5_plain_ms = cuda_ms(torch, lambda: shade_multi_plain(
        prep["quads"], lines, pack_pm, rp_pm, wb, spec), 2)
    k6_plain_ms = cuda_ms(torch, lambda: shade_multi_patch_plain(
        prep8["ptabs"], lines, pack_pm, rp_pm, wb, spec, pspecs), 2)
    k4_plain_ms = cuda_ms(torch, lambda: patch_blend_plain(
        prep8["ptabs"], pack_pm, pspecs), 2)
    pre_plain_ms = cuda_ms(torch, lambda: shade_multi_preblended_plain(
        feats, lines, pack_pm, rp_pm, wb, spec), 2)

    valid_pm = valid_count(pack_pm)
    out_bytes = CHUNK * 5 * 4
    mlp_ops = 2 * CHUNK * sum(
        p["weight"].numel() for p in
        params["embedding"]["ray_prediction_0"]["net"].values())
    k1_bound = bound(
        nbytes(net_in, rp, pack) + sum(nbytes(l.w, l.b) for l in tabs.layers),
        [(mlp_ops, BF16_OPS_PER_S),
         (N * (K1_TAIL_OPS + (K1_CONTRACT_OPS if cf.spec.contract.name
                              != "identity" else 0)), F32_OPS_PER_S)])
    # the table bytes: only the rows this chunk reads, each once
    quad_bytes = sum(rows_bytes(q, quad_rows(pack_pm, a.m0, a.m1, a.W, a.H))
                     for q, a in zip(prep["quads"], axes))
    ptab_bytes = [sum(rows_bytes(t, patch_rows(pack_pm, ps, every))
                      for t, ps in zip(prep8["ptabs"], pspecs))
                  for every in (False, True)]
    shared = (nbytes(pack_pm, *lines) + ray_bytes(rp_pm, rgb_colour, timed)
              + out_bytes)
    k5_bound = sh_bound(
        f"{family} K5", shared + quad_bytes,
        lambda f: [(valid_pm * multi_ops(axes, lambda C: 8 * C + 10,
                                         rgb_colour, fold=f)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    pre_bound = sh_bound(
        f"{family} K5-pre", shared + nbytes(*feats),
        lambda f: [(valid_pm * multi_ops(axes, lambda C: C, rgb_colour,
                                         fold=f)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    k6_bound = sh_bound(
        f"{family} K6", shared + ptab_bytes[0] + 4,
        lambda f: [(valid_pm * multi_ops(axes, lambda C: 8 * C + 22,
                                         rgb_colour, fold=f)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    k4_bound = bound(
        nbytes(pack_pm[:4], *feats) + ptab_bytes[1] + 4,
        [(N * sum(8 * a.C + 22 for a in axes), F32_OPS_PER_S)])
    k1_plan(torch, family, cf, tabs, mlp_ops, k1_ms)
    print(f"# {family} chunk ({card}): K1 {k1_ms:.3f} ms (plain "
          f"{k1_plain_ms:.3f}, bound {k1_bound[0]:.4f} {k1_bound[1]}); K5 "
          f"{k5_ms:.3f}, on the scanline chunk {k5_scan_ms:.3f} (plain "
          f"{k5_plain_ms:.3f}, bound {k5_bound[0]:.4f} {k5_bound[1]}); K6 "
          f"{k6_ms:.3f} (plain {k6_plain_ms:.3f}, bound "
          f"{k6_bound[0]:.4f} {k6_bound[1]}, share "
          f"{100 * k6_bound[0] / k6_ms:.1f} %, before the redesign "
          f"{BEFORE_MS[f'{family} K6']:.3f}); K4 x3 {k4_ms:.3f} (plain "
          f"{k4_plain_ms:.3f}, bound {k4_bound[0]:.4f} {k4_bound[1]}); "
          f"K5-preblended {pre_ms:.3f} (plain {pre_plain_ms:.3f}, bound "
          f"{pre_bound[0]:.4f} {pre_bound[1]}, share "
          f"{100 * pre_bound[0] / pre_ms:.1f} %); {valid_pm} of {N} samples "
          f"valid; MLP {mlp_ops / 1e9:.1f} GFLOP; table rows the chunk "
          f"reads: quad {quad_bytes / 1e6:.1f} of "
          f"{nbytes(*prep['quads']) / 1e6:.1f} MB, patch (K6) "
          f"{ptab_bytes[0] / 1e6:.1f}, (K4) {ptab_bytes[1] / 1e6:.1f} of "
          f"{nbytes(*prep8['ptabs']) / 1e6:.1f} MB", flush=True)
    del feats, pre, fused, quad_pm, pack_pm, out
    torch.cuda.empty_cache()

    # ---- 11. the bench frame through model.apply on each route
    def render(m, frames, rkw):
        return [m.apply(params, frames[i], ctx, rkw)
                for i in range(frames.shape[0])]

    n_chunks = frame6.shape[0]
    _, model4, _, prep4 = static_model(dev, family, patch=PATCH_R4,
                                       params=params)
    rk = {"cf_prepared": prep}
    rk8 = {"cf_prepared": prep8, "rays_phase_major": True}
    rk4 = {"cf_prepared": prep4, "rays_phase_major": True}
    R4 = PATCH_R4[2]
    frame_pm4 = phase_major(frame6, R4).contiguous()
    # name: (HYPERREEL_FUSED_PATCH_MULTI, model, frame, render_kwargs,
    # launches per frame, R of the phase-major rays)
    routes = {
        f"{family} quad": ("0", model, frame6, rk,
                      {"shade_multi": n_chunks}, None),
        f"{family} fused patch": ("1", model8, frame_pm, rk8,
                             {"shade_multi_patch": n_chunks}, R8),
        f"{family} two-kernel patch": ("0", model8, frame_pm, rk8,
                                  {"patch_blend": n_chunks,
                                   "shade_multi_preblended": n_chunks}, R8),
        f"{family} fused patch R=4 (4,3)": (
            "1", model4, frame_pm4, rk4, {"shade_multi_patch": n_chunks}, R4),
        f"{family} two-kernel patch R=4 (4,3)": (
            "0", model4, frame_pm4, rk4,
            {"patch_blend": n_chunks,
             "shade_multi_preblended": n_chunks}, R4)}
    counts, rgb_quad = {}, None
    for name, (env, m, frames, rkw, kern, R) in routes.items():
        with EnvVar("HYPERREEL_FUSED_PATCH_MULTI", env):
            reset_counts()
            outs = render(m, frames, rkw)
            torch.cuda.synchronize()
            got = read_counts()
        want = dict.fromkeys(got, 0)
        want.update(pack_build=n_chunks, **kern)
        counts[name] = got
        rgb = torch.cat([scanline(o["rgb"], R) if R else o["rgb"]
                         for o in outs])
        if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                and rgb.max() <= 1 and rgb.shape == (SIDE * SIDE, 3)):
            raise AssertionError(f"{name}: frame rgb is not finite in [0, 1]")
        if got != want:
            raise AssertionError(f"{name}: kernel launches {got}, want {want}")
        if R is None:
            rgb_quad = rgb
            print(f"# frame {SIDE}x{SIDE} ({name}): rgb min "
                  f"{rgb.min().item():.4f} max {rgb.max().item():.4f} mean "
                  f"{rgb.mean().item():.4f}; launches {got}", flush=True)
            continue
        pviol = max(float(o["patch_coverage_viol"]) for o in outs)
        err = (rgb - rgb_quad).abs().max().item()
        print(f"# frame ({name}, phase-major rays): launches {got}; coverage "
              f"witness {pviol:.3e} (gate {PVIOL_EXACT}); rgb vs the quad "
              f"route's frame {err:.3e} (tol {PATH_TOL})", flush=True)
        # at R=4 (4, 3) the frame's footprints stay inside their patches,
        # so both patch routes must render the quad route's frame; at R=8
        # (5, 2) they do not, and the witness says so
        exact = pviol <= PVIOL_EXACT
        if (R == R4 and not exact) or (exact and not err <= PATH_TOL):
            raise AssertionError(f"{name}: witness {pviol}, rgb error {err}")

    # ---- 12. fused vs general path on 4096 rays, f32 MLP policy (the
    # general chain and the general colour net)
    import copy
    from hyperreel_tpu_torch.models.model import build_model
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"].update(fused_render_cf=False, fused_render=False)
    fused_m = build_model(cfg)
    general = build_model(cfg_g)
    rays = torch.from_numpy(entry_rays(4096)[:, :6].copy()).to(dev)
    a = fused_m.apply(params, rays, ctx)["rgb"]
    b = general.apply(params, rays, ctx)["rgb"]
    path_err = (a - b).abs().max().item()
    print(f"# {family} fused vs general, 4096 entry() rays: max |diff| "
          f"{path_err:.3e} (tol {PATH_TOL})", flush=True)
    if not path_err <= PATH_TOL:
        raise AssertionError(f"{family} fused and general paths disagree: "
                             f"{path_err}")
    own = {}
    if family == "shiny":
        # the bench frame through the general chain and the net's own fused
        # route (fused_render_cf off: K5 with the weights row), f32 MLP
        # policy; its first chunk against the channels-first quad route's
        cfg_o = copy.deepcopy(cfg)
        cfg_o["color"]["net"]["fused_render_cf"] = False
        own_m = build_model(cfg_o)
        prep_o = own_m.prepare_eval(params)
        rko = {"cf_prepared": prep_o}
        reset_counts()
        a = render(own_m, frame6, rko)[0]["rgb"]
        torch.cuda.synchronize()
        own["counts"] = read_counts()
        b = fused_m.apply(params, frame6[0], ctx)["rgb"]
        own_err = (a - b).abs().max().item()
        own["ms"] = cuda_ms(torch, lambda: own_m.apply(params, frame6[0],
                                                       ctx, rko), 5)
        want = dict.fromkeys(own["counts"], 0)
        want.update(shade_multi=n_chunks)
        print(f"# {family} own fused route (general chain + K5 with the "
              f"weights row), the frame: launches {own['counts']}; its "
              f"first chunk's rgb vs the channels-first quad route "
              f"{own_err:.3e} (tol {PATH_TOL}); {own['ms']:.3f} ms per "
              f"chunk", flush=True)
        if own["counts"] != want or not own_err <= PATH_TOL:
            raise AssertionError(f"{family} own fused route: launches "
                                 f"{own['counts']}, rgb error {own_err}")
        del own_m, prep_o
    del fused_m, general, a, b

    # ---- 13. frame time of the routes, in turns
    names = list(routes)
    times = {name: [] for name in names}
    for name in (names + names[::-1]) * 2:
        env, m, frames, rkw = routes[name][:4]
        with EnvVar("HYPERREEL_FUSED_PATCH_MULTI", env):
            times[name].append(cuda_ms(
                torch, lambda: render(m, frames, rkw), TIMED_FRAMES))
    frame_ms = {}
    for name, ts in times.items():
        frame_ms[name] = sum(ts) / len(ts)
        print(f"# {card}: {name} route {frame_ms[name]:.3f} ms/frame, "
              f"{SIDE * SIDE / frame_ms[name] / 1e3:.3f} Mrays/s "
              f"({TIMED_FRAMES} frames after a warm-up frame, 4 times: "
              + ", ".join(f"{t:.3f}" for t in ts) + ")", flush=True)

    src = "hyperreel_tpu/ops/pallas/"
    # llff keeps the names of earlier records; shiny's are the RGB forms
    sfx = "_rgb" if rgb_colour else ""
    records = [
        entry(f"pack_build_{family}", "pack_build.cuh",
              src + "pack_build.py:137",
              counts[f"{family} quad"]["pack_build"], k1_err, k1_ms,
              k1_plain_ms, k1_bound),
        entry(f"shade_multi{sfx}", "shade_multi.cu", src + "shade.py:742",
              counts[f"{family} quad"]["shade_multi"], k5_err, k5_ms,
              k5_plain_ms, k5_bound),
        entry(f"shade_multi_preblended{sfx}", "shade_multi.cu",
              src + "shade.py:761",
              counts[f"{family} two-kernel patch"]["shade_multi_preblended"],
              pre_err, pre_ms, pre_plain_ms, pre_bound),
        entry(f"patch_blend_{family}_3_planes", "patch_blend.cu",
              src + "patch_blend.py:51",
              counts[f"{family} two-kernel patch"]["patch_blend"], k4_err,
              k4_ms, k4_plain_ms, k4_bound),
        entry(f"shade_multi_patch{sfx}", "shade_multi_patch.cu",
              src + "shade.py:786",
              counts[f"{family} fused patch"]["shade_multi_patch"], k6_err,
              k6_ms, k6_plain_ms, k6_bound)]
    if own:
        records.append(entry(
            f"shade_multi{sfx}_weights", "shade_multi.cu",
            src + "shade.py:742", own["counts"]["shade_multi"], k5w_err,
            k5w_ms, k5w_plain_ms, k5w_bound))
    return records, frame_ms

def stanford_phases(torch, dev, card, frame, reset_counts, read_counts):
    """Phases 24-27: stanford_llff_z_plane through the general stage chain
    and its net's own fused route (K2 with RGB colour, the weights row and
    the z line as the premixed table): K2 against its plain version on one
    chunk of the bench frame, the frame through model.apply, against the
    general colour net, and the frame times of both. Returns (the kernel's
    JSON record, {route: ms/frame})."""
    import copy

    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels.shade import shade, shade_plain

    ctx = StepCtx(it=IT)
    # ---- 24. the model at the checkpoint grid
    cfg, model, params, prep = static_model(dev, "stanford")
    net = model.color_net
    if model._cf_eval is not None:
        raise AssertionError("stanford_llff_z_plane took the channels-first "
                             "route")
    ax, = prep["axes"]
    quad, line, wb = prep["quads"][0], prep["lines"][0], prep["wb"]
    print(f"# stanford_llff_z_plane: plane {ax.H}x{ax.W}x{ax.C}; line "
          f"{ax.L}; quad table {nbytes(quad) / 1e6:.1f} MB", flush=True)
    frame6 = frame[..., :6].contiguous()

    # ---- 25. one chunk: the general chain, then K2 (RGB, weights row)
    # against its plain version
    chunk = frame6[0]

    def chain(rays):
        return model.embedding.apply(params["embedding"],
                                     model.ray_param.apply(rays), ctx, {})

    pack, rp = net.fused_pack(chain(chunk))
    spec = net.fused_spec(prep, pack.shape[1] // CHUNK)
    N = pack.shape[1]
    valid = valid_count(pack)
    out = shade(quad, pack, rp, line, wb, spec)
    out_p = shade_plain(quad, pack, rp, line, wb, spec)
    torch.cuda.synchronize()
    k2_err = (out[:, :4] - out_p[:, :4]).abs().max().item()
    k2_derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
    print(f"# stanford chunk: {valid} of {N} samples valid "
          f"({100 * valid / N:.1f} %); K2 shade (RGB, weights row, the z "
          f"line as its TH = 0 table): max |kernel - plain| rgb/acc "
          f"{k2_err:.3e}, depth {k2_derr:.3e} (tol {SHADE_TOL}); acc mean "
          f"{out[:, 3].mean().item():.4f}", flush=True)
    if valid < N // 4:
        raise AssertionError("under a quarter of the samples are valid: "
                             "move the camera")
    if not (k2_err <= SHADE_TOL and k2_derr <= 10 * SHADE_TOL):
        raise AssertionError(f"K2 (RGB, weights row) disagrees with its "
                             f"plain version: {k2_err}, {k2_derr}")
    k2_ms = cuda_ms(torch, lambda: shade(quad, pack, rp, line, wb, spec),
                    20)
    k2_plain_ms = cuda_ms(torch, lambda: shade_plain(quad, pack, rp, line,
                                                     wb, spec), 2)
    chain_ms = cuda_ms(torch, lambda: chain(chunk), 5)
    k2_bound = bound(
        pack_bytes(pack, valid) + ray_bytes(rp, True, spec.TH > 0)
        + nbytes(line) + CHUNK * 5 * 4
        + rows_bytes(quad, quad_rows(pack, 0, 1, ax.W, ax.H)),
        [(valid * (shade_ops(ax.C, ax.nd, True, True) + 8 * ax.C + 10)
          + N * COMPOSITE_OPS, F32_OPS_PER_S)])
    print(f"# stanford chunk ({card}): K2 {k2_ms:.3f} ms (plain "
          f"{k2_plain_ms:.3f}, bound {k2_bound[0]:.4f} {k2_bound[1]}); the "
          f"general chain before it {chain_ms:.3f} ms", flush=True)
    del out, out_p, pack, rp
    torch.cuda.empty_cache()

    # ---- 26. the bench frame through model.apply (the general chain and
    # K2), and through the general colour net
    def render(m, rkw):
        return [m.apply(params, frame6[i], ctx, rkw)
                for i in range(frame6.shape[0])]

    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"]["fused_render"] = False
    general = build_model(cfg_g, compute_dtype=torch.bfloat16)
    rk = {"cf_prepared": prep}
    n_chunks = frame6.shape[0]
    reset_counts()
    outs = render(model, rk)
    torch.cuda.synchronize()
    counts = read_counts()
    rgb = torch.cat([o["rgb"] for o in outs])
    want = dict.fromkeys(counts, 0)
    want.update(shade=n_chunks)
    if not (torch.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1
            and rgb.shape == (SIDE * SIDE, 3)):
        raise AssertionError("stanford: frame rgb is not finite in [0, 1]")
    if counts != want:
        raise AssertionError(f"stanford: kernel launches {counts}, want "
                             f"{want}")
    # ---- 27. against the general colour net on the same chain
    rgb_g = torch.cat([o["rgb"] for o in render(general, {})])
    path_err = (rgb - rgb_g).abs().max().item()
    print(f"# frame {SIDE}x{SIDE} (stanford own fused route): rgb min "
          f"{rgb.min().item():.4f} max {rgb.max().item():.4f} mean "
          f"{rgb.mean().item():.4f}; launches {counts}; vs the general "
          f"colour net {path_err:.3e} (tol {PATH_TOL})", flush=True)
    if not path_err <= PATH_TOL:
        raise AssertionError(f"stanford fused and general paths disagree: "
                             f"{path_err}")
    del outs, rgb, rgb_g

    # ---- 28. frame time of the own route and of the general path, in
    # turns
    routes = {"stanford own fused route": (model, rk),
              "stanford general path": (general, {})}
    times = {name: [] for name in routes}
    for name in (list(routes) + list(routes)[::-1]) * 2:
        m, rkw = routes[name]
        times[name].append(cuda_ms(torch, lambda: render(m, rkw),
                                   N3D_TIMED_FRAMES))
    frame_ms = {}
    for name, ts in times.items():
        frame_ms[name] = sum(ts) / len(ts)
        print(f"# {card}: {name} {frame_ms[name]:.3f} ms/frame, "
              f"{SIDE * SIDE / frame_ms[name] / 1e3:.3f} Mrays/s "
              f"({N3D_TIMED_FRAMES} frames after a warm-up frame, 4 times: "
              + ", ".join(f"{t:.3f}" for t in ts) + ")", flush=True)
    return [entry("shade_rgb_weights", "shade.cu",
                  "hyperreel_tpu/ops/pallas/shade.py:238", counts["shade"],
                  k2_err, k2_ms, k2_plain_ms, k2_bound)], frame_ms


# The non-planar primitive presets: each renders through the general
# stage chain and its colour net's own fused route (K5: catacaustics at
# the [8, 8, 8] layout with SH and the weights row, S = 64; immersive on
# time planes, S = 32; donerf with RGB and the weights row, S = 32), with
# the dataset_info the port's loaders give (primitive_info), the density
# grids redrawn uniform in [0, density), and the camera at
# (0, 0, oz) where most samples are valid: catacaustics' distances are
# anchored on [-far, far] about each ray's closest point to the origin, so
# a camera 8 away puts nearly all of them in front of it; the spheres of
# immersive (outward facing) and donerf are about the origin, and a camera
# inside them hits every one.
PRIMITIVES = {"catacaustics": ("catacaustics_distance", 0.1, -8.0),
              "immersive": ("immersive_sphere_new", 0.05, -0.5),
              "donerf": ("donerf_sphere", 0.2, 0.0)}


def primitive_info(family):
    """The family's dataset_info from the port's loader, where the loader
    fixes it without a scene: catacaustics' bounds, and immersive's for
    02_Flames over the published 50-frame window with a keyframe every 4.
    DONeRF reads its depth range from the scene's dataset_info.json
    (data/donerf.py): here the repo's fixture's, tests/test_datasets.py."""
    from hyperreel_tpu_torch.data import catacaustics, immersive
    if family == "catacaustics":
        return catacaustics.scene_info()
    if family == "immersive":
        return immersive.scene_info("02_Flames")
    return {"near": 0.5, "far": 6.0, "depth_range": (0.5, 6.0)}


PRIMITIVE_TIMED_FRAMES = 1


def bf16_second_factors(torch, params):
    """The colour params with every line and time plane rounded to bf16:
    the general colour net reads them at table precision, the own fused
    route in f32, and on values that bf16 represents both read the same."""
    color = {fam: dict(v) if isinstance(v, dict) else v
             for fam, v in params["color"].items()}
    for fam in ("density", "app"):
        for k, v in color[fam].items():
            if k.startswith(("line_", "time_")):
                color[fam][k] = v.to(torch.bfloat16).float()
    return dict(params, color=color)


def primitive_model(dev, family, fused=True, params=None):
    """The family's preset at full width under the bf16 MLP policy on a
    trained checkpoint's grid (N_voxel_init set to N_voxel_final; the
    port's n_to_reso reads the aabb [-2, 2]^3 as a cube: catacaustics
    400^3, immersive 640^3, donerf 600^3); with `fused` False the general
    colour net. Weights from torch.Generator seed SEED (or the given
    params), the density grids redrawn uniform in [0, density), the lines
    and time planes bf16-representable: (cfg, model, params)."""
    import torch

    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.models.model import build_model

    preset, density, _ = PRIMITIVES[family]
    info = primitive_info(family)
    cfg = presets.convert_epochs_to_iters(getattr(presets, preset)(),
                                          iters_per_epoch=4000)
    net = cfg["color"]["net"]
    net["N_voxel_init"] = net["N_voxel_final"]
    net["fused_render"] = fused
    model = build_model(cfg, dataset_info=info, compute_dtype=torch.bfloat16)
    if params is None:
        gen = torch.Generator().manual_seed(SEED)
        params = model.init(gen, dev)
        for k, v in params["color"]["density"].items():
            params["color"]["density"][k] = density * torch.rand(
                v.shape, generator=gen).to(dev)
        params = bf16_second_factors(torch, params)
    return cfg, model, params


def primitive_phases(torch, dev, card, reset_counts, read_counts, family):
    """Phases 29-32 (catacaustics_distance), 33-36 (immersive_sphere_new)
    or 37-40 (donerf_sphere): on one chunk of the family's frame, the
    general chain then K5 against its plain version (immersive also with a
    t per ray), the valid share; the frame through model.apply (K5 once
    per chunk, nothing else); against the general colour net; the frame
    times of both, and of the chain and K5 per chunk. Returns (the
    kernel's JSON record, {route: ms/frame})."""
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        shade_multi, shade_multi_plain)

    ctx = StepCtx(it=IT)
    preset, _, oz = PRIMITIVES[family]
    info = primitive_info(family)
    cfg, model, params = primitive_model(dev, family)
    net = model.color_net
    if model._cf_eval is not None:
        raise AssertionError(f"{preset} took the channels-first route")
    prep = model.prepare_eval(params)
    axes = prep["axes"]
    timed = any(a.TH for a in axes)
    rgb_colour = net.shading == "rgb"
    layout = "[" + ", ".join(str(a.nd) for a in axes) + "]"
    print(f"# {preset} ({card}): {layout} {net.shading} planes " + ", ".join(
        f"{a.H}x{a.W}x{a.C}" for a in axes) + "; " + (
        f"time planes {axes[0].TH} keyframes x " if timed else "lines ")
        + ", ".join(str(a.L) for a in axes) + f"; quad tables "
        f"{sum(nbytes(q) for q in prep['quads']) / 1e6:.1f} MB; camera at "
        f"(0, 0, {oz}); dataset_info {info}", flush=True)
    frame = torch.from_numpy(bench_frame()).to(dev)
    frame[..., 2] = oz
    if not timed:
        frame = frame[..., :6].contiguous()       # a static scene: o, d

    # ---- 29 / 33 / 37. one chunk: the general chain, then K5 against its
    # plain version
    def chain(rays):
        return model.embedding.apply(params["embedding"],
                                     model.ray_param.apply(rays), ctx, {})

    chunk = frame[0]
    chunks = {"one t" if timed else "chunk": chunk}
    if timed:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        chunk_t = chunk.clone()
        chunk_t[:, 7] = torch.rand(CHUNK, device=dev, generator=gen)
        chunks["a t per ray"] = chunk_t
    k5_err = 0.0
    for name, rays in chunks.items():
        pack, rp = net.fused_pack(chain(rays))
        spec = net.fused_spec(prep, pack.shape[1] // CHUNK)
        out = shade_multi(prep["quads"], prep["lines"], pack, rp, prep["wb"],
                          spec)
        out_p = shade_multi_plain(prep["quads"], prep["lines"], pack, rp,
                                  prep["wb"], spec)
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        N = pack.shape[1]
        valid = valid_count(pack)
        print(f"# {family} chunk ({name}): {valid} of {N} samples valid "
              f"({100 * valid / N:.1f} %); K5 shade_multi {layout} "
              f"{net.shading}{', weights row' if spec.weights else ''}"
              f"{', time planes' if timed else ''}, S={spec.S}: max |kernel "
              f"- plain| rgb/acc {err:.3e}, depth {derr:.3e} (tol "
              f"{SHADE_TOL}); acc mean {out[:, 3].mean().item():.4f}; "
              f"{k5_launch(shade_multi)}", flush=True)
        if valid < N // 2:
            raise AssertionError(f"{family}: under half of the samples are "
                                 "valid: move the camera")
        if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL):
            raise AssertionError(f"{family} K5 disagrees with its plain "
                                 f"version: {err}, {derr}")
        k5_err = max(k5_err, err)
        del out, out_p
    # the chunk with one t (a frame's) for the times and the bound
    x = chain(chunk)
    pack, rp = net.fused_pack(x)
    spec = net.fused_spec(prep, pack.shape[1] // CHUNK)
    N, valid = pack.shape[1], valid_count(pack)
    quads, lines, wb = prep["quads"], prep["lines"], prep["wb"]
    k5_ms = cuda_ms(torch, lambda: shade_multi(quads, lines, pack, rp, wb,
                                               spec), 20)
    k5_plain_ms = cuda_ms(torch, lambda: shade_multi_plain(
        quads, lines, pack, rp, wb, spec), 2)
    chain_ms = cuda_ms(torch, lambda: chain(chunk), 3)
    pack_ms = cuda_ms(torch, lambda: net.fused_pack(x), 5)
    k5_bound = sh_bound(
        f"{family} K5", pack_bytes(pack, valid)
        + ray_bytes(rp, rgb_colour, timed) + nbytes(*lines) + CHUNK * 5 * 4
        + sum(rows_bytes(q, quad_rows(pack, a.m0, a.m1, a.W, a.H))
              for q, a in zip(quads, axes)),
        lambda f: [(valid * multi_ops(axes, lambda C: 8 * C + 10,
                                      rgb_colour, spec.weights, fold=f)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], spec.S)
    print(f"# {family} chunk ({card}): the general chain {chain_ms:.3f} ms, "
          f"the pack from its fields {pack_ms:.3f} ms, K5 {k5_ms:.3f} ms "
          f"(plain {k5_plain_ms:.3f}, bound {k5_bound[0]:.4f} "
          f"{k5_bound[1]}, {100 * k5_bound[0] / k5_ms:.1f} % of it)",
          flush=True)
    del x, pack, rp
    torch.cuda.empty_cache()

    # ---- 30 / 34 / 38. the frame through model.apply (the general chain
    # and K5), with one t and, for immersive, a t per ray
    def render(m, frames, rkw):
        return [m.apply(params, frames[i], ctx, rkw)
                for i in range(frames.shape[0])]

    _, general, _ = primitive_model(dev, family, fused=False, params=params)
    rk = {"cf_prepared": prep}
    n_chunks = frame.shape[0]
    frames = {"one t" if timed else "frame": frame}
    if timed:
        frame_t = frame.clone()
        frame_t[..., 7] = torch.rand(frame.shape[:2], device=dev,
                                     generator=gen)
        frames["a t per ray"] = frame_t
    counts = None
    for name, frm in frames.items():
        reset_counts()
        outs = render(model, frm, rk)
        torch.cuda.synchronize()
        got = read_counts()
        rgb = torch.cat([o["rgb"] for o in outs])
        want = dict.fromkeys(got, 0)
        want.update(shade_multi=n_chunks)
        if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                and rgb.max() <= 1 and rgb.shape == (SIDE * SIDE, 3)):
            raise AssertionError(f"{family}: frame rgb is not finite in "
                                 "[0, 1]")
        if got != want:
            raise AssertionError(f"{family}: kernel launches {got}, want "
                                 f"{want}")
        counts = counts or got
        # ---- 31 / 35 / 39. against the general colour net on the same
        # chain
        rgb_g = torch.cat([o["rgb"] for o in render(general, frm, {})])
        path_err = (rgb - rgb_g).abs().max().item()
        print(f"# frame {SIDE}x{SIDE} ({family} own fused route, {name}): "
              f"rgb min {rgb.min().item():.4f} max {rgb.max().item():.4f} "
              f"mean {rgb.mean().item():.4f}; launches {got}; vs the general "
              f"colour net {path_err:.3e} (tol {PATH_TOL})", flush=True)
        if not path_err <= PATH_TOL:
            raise AssertionError(f"{family} own route and general colour net "
                                 f"disagree ({name}): {path_err}")
        del outs, rgb, rgb_g
    torch.cuda.empty_cache()

    # ---- 32 / 36 / 40. frame time of the own route and of the general
    # path, in turns (own, general, general, own)
    routes = {f"{family} own fused route": model,
              f"{family} general path": general}
    times = {name: [] for name in routes}
    for name in list(routes) + list(routes)[::-1]:
        times[name].append(cuda_ms(torch, lambda: render(
            routes[name], frame, rk if routes[name] is model else {}),
            PRIMITIVE_TIMED_FRAMES))
    frame_ms = {}
    for name, ts in times.items():
        frame_ms[name] = sum(ts) / len(ts)
        print(f"# {card}: {name} {frame_ms[name]:.3f} ms/frame, "
              f"{SIDE * SIDE / frame_ms[name] / 1e3:.3f} Mrays/s "
              f"({PRIMITIVE_TIMED_FRAMES} frames after a warm-up frame, "
              "twice: " + ", ".join(f"{t:.3f}" for t in ts) + ")",
              flush=True)
    own_ms = frame_ms[f"{family} own fused route"]
    print(f"# {family} where the own route's frame goes ({card}): "
          f"{n_chunks} x the general chain {n_chunks * chain_ms:.3f} ms "
          f"({100 * n_chunks * chain_ms / own_ms:.1f} %), the pack "
          f"{n_chunks * pack_ms:.3f} ms "
          f"({100 * n_chunks * pack_ms / own_ms:.1f} %), K5 "
          f"{n_chunks * k5_ms:.3f} ms ({100 * n_chunks * k5_ms / own_ms:.1f} "
          "%) of the frame", flush=True)
    name = {"catacaustics": "shade_multi_888_sh_weights",
            "immersive": "shade_multi_immersive_time_planes",
            "donerf": "shade_multi_rgb_weights_donerf"}[family]
    return [entry(name, "shade_multi.cu",
                  "hyperreel_tpu/ops/pallas/shade.py:742",
                  counts["shade_multi"], k5_err, k5_ms, k5_plain_ms,
                  k5_bound)], frame_ms


FACE_ULPS = 2


def near_face(torch, pack, S):
    """[B]: rays with a sample whose |xn|, |yn| or |zn| lies within
    FACE_ULPS f32 ulps of 1 (the reference's hard validity step keeps or
    drops such a sample by its last ulp, ROADMAP.md 3)."""
    one = torch.tensor(1.0).view(torch.int32).item()
    bits = pack[:3].abs().contiguous().view(torch.int32).long()
    return ((bits - one).abs().amin(0) <= FACE_ULPS).reshape(-1, S).any(1)


def flagship_own_phase(torch, dev, card, cfg, info, params, frame,
                       reset_counts, read_counts):
    """Phases 41-43: the flagship with fused_render_cf off, through the
    general stage chain and the dynamic net's single-axis own route (K2 on
    its time plane, the time coordinate per ray): the bench frame's
    launches, its rgb against the general colour net and against the
    channels-first route's frame; under the f32 MLP policy on F32_RAYS rays
    of the first chunk against the channels-first route; the frame time of
    both routes. The time plane is rounded to bf16 for all of them (see
    bf16_second_factors). Returns (the kernel's JSON record, {route:
    ms/frame})."""
    import copy

    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build
    from hyperreel_tpu_torch.ops.kernels.shade import shade, shade_plain

    ctx = StepCtx(it=IT)
    cfg_o = copy.deepcopy(cfg)
    cfg_o["color"]["net"]["fused_render_cf"] = False
    cfg_g = copy.deepcopy(cfg_o)
    cfg_g["color"]["net"]["fused_render"] = False
    own, general, cf_model = (
        build_model(c, dataset_info=info, compute_dtype=torch.bfloat16)
        for c in (cfg_o, cfg_g, cfg))
    if own._cf_eval is not None:
        raise AssertionError("the flagship with fused_render_cf off took the "
                             "channels-first route")
    p16 = bf16_second_factors(torch, params)
    prep = own.prepare_eval(p16)
    ax, = prep["axes"]
    net = own.color_net

    # ---- 41. K2 on the own route's pack of one chunk; the bench frame
    chunk = frame[0]
    x = own.embedding.apply(p16["embedding"], chunk, ctx, {})
    pack, rp = net.fused_pack(x)
    spec = net.fused_spec(prep, pack.shape[1] // CHUNK)
    out = shade(prep["quads"][0], pack, rp, prep["lines"][0], prep["wb"],
                spec)
    out_p = shade_plain(prep["quads"][0], pack, rp, prep["lines"][0],
                        prep["wb"], spec)
    torch.cuda.synchronize()
    k2_err = (out[:, :4] - out_p[:, :4]).abs().max().item()
    if not k2_err <= SHADE_TOL:
        raise AssertionError(f"K2 on the own route's pack disagrees with its "
                             f"plain version: {k2_err}")
    k2_ms = cuda_ms(torch, lambda: shade(prep["quads"][0], pack, rp,
                                         prep["lines"][0], prep["wb"], spec),
                    20)
    k2_plain_ms = cuda_ms(torch, lambda: shade_plain(
        prep["quads"][0], pack, rp, prep["lines"][0], prep["wb"], spec), 2)
    N, valid = pack.shape[1], valid_count(pack)
    k2_bound = sh_bound(
        "flagship own K2", nbytes(pack, rp, prep["lines"][0])
        + CHUNK * 5 * 4 + rows_bytes(prep["quads"][0],
                                     quad_rows(pack, 0, 1, ax.W, ax.H)),
        lambda f: [(valid * (shade_ops(ax.C, ax.nd, fold=f) + 8 * ax.C + 10)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], spec.S)
    print(f"# flagship own route chunk ({card}): K2 on the time plane "
          f"(TH={spec.TH}, t per ray): max |kernel - plain| rgb/acc "
          f"{k2_err:.3e} (tol {SHADE_TOL}); {k2_ms:.3f} ms (plain "
          f"{k2_plain_ms:.3f}, bound {k2_bound[0]:.4f} {k2_bound[1]})",
          flush=True)
    del x, pack, rp, out, out_p

    def render(m, rkw, prm):
        return [m.apply(prm, frame[i], ctx, rkw)
                for i in range(frame.shape[0])]

    rk = {"cf_prepared": prep}
    reset_counts()
    outs = render(own, rk, p16)
    torch.cuda.synchronize()
    counts = read_counts()
    rgb = torch.cat([o["rgb"] for o in outs])
    want = dict.fromkeys(counts, 0)
    want.update(shade=frame.shape[0])
    if counts != want:
        raise AssertionError(f"flagship own route: kernel launches {counts}, "
                             f"want {want}")
    if not (torch.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1
            and rgb.shape == (SIDE * SIDE, 3)):
        raise AssertionError("flagship own route: frame rgb is not finite in "
                             "[0, 1]")
    # ---- 42. against the general colour net and the channels-first
    # route's frame
    rgb_g = torch.cat([o["rgb"] for o in render(general, {}, p16)])
    g_err = (rgb - rgb_g).abs().max().item()
    rgb_cf = torch.cat([o["rgb"] for o in render(
        cf_model, {"cf_prepared": cf_model.prepare_eval(p16),
                   "uniform_time": True}, p16)])
    cf_diff = (rgb - rgb_cf).abs().amax(1)
    print(f"# frame {SIDE}x{SIDE} (flagship own route, fused_render_cf "
          f"off): launches {counts}; vs the general colour net {g_err:.3e} "
          f"(tol {PATH_TOL}); vs the channels-first route's frame (bf16 MLP "
          f"policy: its general MLP stores each layer in bf16, K1 keeps f32 "
          f"sums) max {cf_diff.max().item():.3e}, "
          f"{int((cf_diff > PATH_TOL).sum())} rays above {PATH_TOL}",
          flush=True)
    if not g_err <= PATH_TOL:
        raise AssertionError(f"flagship own route and general colour net "
                             f"disagree: {g_err}")
    del outs, rgb_g, rgb_cf, cf_model
    # under the f32 MLP policy both routes run the same MLP: the own route
    # against the channels-first route on F32_RAYS rays of the chunk, the
    # rays with a sample on an aabb face in either pack left out
    own32 = build_model(cfg_o, dataset_info=info)
    cf32 = build_model(cfg, dataset_info=info)
    rays = chunk[:F32_RAYS].contiguous()
    a = own32.apply(p16, rays, ctx, {"cf_prepared": own32.prepare_eval(p16)})
    prep32 = cf32.prepare_eval(p16)
    b = cf32.apply(p16, rays, ctx, {"cf_prepared": prep32,
                                    "uniform_time": True})
    pk_own = own32.color_net.fused_pack(own32.embedding.apply(
        p16["embedding"], rays, ctx, {}))[0]
    cf = cf32._cf_eval
    pk_cf = pack_build(cf.pred.net_input(rays, ctx).float().contiguous(),
                       prep32["mlp"], cf.ray_pack(rays), cf.spec, IT)
    near = near_face(torch, pk_own, cf.S) | near_face(torch, pk_cf, cf.S)
    f32_err = (a["rgb"] - b["rgb"])[~near].abs().max().item()
    print(f"# flagship own vs channels-first route, f32 MLP policy, "
          f"{F32_RAYS} rays: max |diff| {f32_err:.3e} (tol {PATH_TOL}) over "
          f"the rays without a sample within {FACE_ULPS} ulps of an aabb "
          f"face ({int(near.sum())} left out); with them "
          f"{(a['rgb'] - b['rgb']).abs().max().item():.3e}", flush=True)
    if not (f32_err <= PATH_TOL and int(near.sum()) <= F32_RAYS // 100):
        raise AssertionError(f"flagship own and channels-first routes "
                             f"disagree: {f32_err}, {int(near.sum())} rays "
                             "near a face")
    del own32, cf32, a, b, pk_own, pk_cf
    torch.cuda.empty_cache()

    # ---- 43. frame time of the own route, in turns with the general path
    routes = {"flagship own route": (own, rk),
              "flagship general path": (general, {})}
    times = {name: [] for name in routes}
    for name in list(routes) + list(routes)[::-1]:
        m, rkw = routes[name]
        times[name].append(cuda_ms(torch, lambda: render(m, rkw, p16),
                                   PRIMITIVE_TIMED_FRAMES))
    frame_ms = {}
    for name, ts in times.items():
        frame_ms[name] = sum(ts) / len(ts)
        print(f"# {card}: {name} {frame_ms[name]:.3f} ms/frame "
              f"({PRIMITIVE_TIMED_FRAMES} frames after a warm-up frame, "
              "twice: " + ", ".join(f"{t:.3f}" for t in ts) + ")",
              flush=True)
    return [entry("shade_time_plane_own_route", "shade.cu",
                  "hyperreel_tpu/ops/pallas/shade.py:238", counts["shade"],
                  k2_err, k2_ms, k2_plain_ms, k2_bound)], frame_ms


def n3d(dev, bf16=True, patch=None, params=None):
    """neural_3d_z_plane at full width (6x256 MLP on 23 inputs, S=64,
    mipnerf contraction, spatial flow, [8, 4, 4] components on three
    space-plane x time-plane axes, SH degree 2) on a trained checkpoint's
    grid: N_voxel_init set to N_voxel_final (262,144,000 voxels: space
    planes 617x823, 514x823, 514x617; time planes of n3d_info()'s 12
    keyframes along z, y and x), whose bf16 quad tables exceed the 50 MB
    L2. The bf16 (or f32) MLP policy; with `patch` the coherent
    patch-gather route (px, py, R). Weights from torch.Generator seed SEED
    (or the given params) with the density grids redrawn uniform in
    [0, N3D_DENSITY): (cfg, model, params, prepared tables)."""
    import torch

    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, neural_3d_z_plane, with_coherent_gather)
    from hyperreel_tpu_torch.models.model import build_model

    cfg = convert_epochs_to_iters(neural_3d_z_plane(), iters_per_epoch=4000)
    net = cfg["color"]["net"]
    net["N_voxel_init"] = net["N_voxel_final"]
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    model = build_model(cfg, dataset_info=n3d_info(),
                        compute_dtype=torch.bfloat16 if bf16 else None)
    if params is None:
        gen = torch.Generator().manual_seed(SEED)
        params = model.init(gen, dev)
        for k, v in params["color"]["density"].items():
            params["color"]["density"][k] = N3D_DENSITY * torch.rand(
                v.shape, generator=gen).to(dev)
    return cfg, model, params, model.prepare_eval(params)


def k1_tail_ops(S):
    """K1's f32 tail operations per sample: K1_TAIL_OPS at 32 samples, one
    compare-exchange more per sort stage beyond the 15 of S = 32."""
    n = S.bit_length() - 1
    return K1_TAIL_OPS - 15 + n * (n + 1) // 2


def n3d_phases(torch, dev, card, frame, reset_counts, read_counts):
    """Phases 14-18: neural_3d_z_plane's kernels on one chunk against their
    plain versions and timed in turns, the bench frame on its routes with
    one t per frame and with a t per ray, fused vs general path, and the
    routes' frame times. Returns (the kernels' JSON records, {route:
    ms/frame})."""
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.ops.kernels import build
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        pack_build, pack_build_plain)
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        patch_blend, patch_blend_plain)
    from hyperreel_tpu_torch.ops.kernels.shade import premix_time
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        MultiSpec, shade_multi, shade_multi_plain, shade_multi_preblended,
        shade_multi_preblended_folded_plain, shade_multi_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
        shade_multi_patch, shade_multi_patch_folded_plain,
        shade_multi_patch_plain)

    ctx = StepCtx(it=IT)
    # ---- 14. the model at the checkpoint grid, quad and patch routes
    cfg, model, params, prep = n3d(dev)
    _, model8, _, prep8 = n3d(dev, patch=N3D_PATCH_R8, params=params)
    _, model4, _, prep4 = n3d(dev, patch=N3D_PATCH_R4, params=params)
    cf = model._cf_eval
    axes = prep["axes"]
    print("# neural_3d_z_plane: space planes " + ", ".join(
        f"{a.H}x{a.W}x{a.C}" for a in axes) + "; time planes " + ", ".join(
        "x".join(map(str, t.shape)) for t in prep["lines"]) + "; quad "
        f"tables {nbytes(*prep['quads']) / 1e6:.1f} MB, time planes "
        f"{nbytes(*prep['lines']) / 1e6:.2f} MB, patch tables (5,3) "
        f"{nbytes(*prep8['ptabs']) / 1e6:.1f} MB", flush=True)

    # ---- 15. one chunk (the frame's t = 0.3 on every ray): K1 at S = 64
    # under both MLP policies; K5 on the time planes (TH = 12) and on the
    # planes premixed for t; K4 on each plane, K5-preblended and K6 at
    # R=8 (5, 3) on the chunk in bench.py's phase-major order, K6 also at
    # R=4 (4, 3); each against its plain version
    chunk = frame[0]
    net_in = cf.pred.net_input(chunk, ctx).float().contiguous()
    rp = cf.ray_pack(chunk)
    tabs = prep["mlp"]
    pack = pack_build(net_in, tabs, rp, cf.spec, IT)
    pack_p = pack_build_plain(net_in, tabs, rp, cf.spec, IT)
    torch.cuda.synchronize()
    k1_err = (pack - pack_p).abs().max().item()
    del pack_p
    cf32 = n3d(dev, bf16=False, params=params)[1]._cf_eval
    tabs32 = cf32.prepare(params)["mlp"]
    x32, rp32 = net_in[:F32_RAYS].contiguous(), rp[:F32_RAYS].contiguous()
    k1_err32 = (pack_build(x32, tabs32, rp32, cf32.spec, IT)
                - pack_build_plain(x32, tabs32, rp32, cf32.spec, IT)
                ).abs().max().item()
    lib = build.load_library().lib
    rpb = [lib.pack_rays_per_block(c.spec.params(1, t, IT))
           for c, t in ((cf, tabs), (cf32, tabs32))]
    print(f"# n3d K1 pack_build S={cf.S} (flow + mipnerf contraction; "
          f"{rpb[0]} rays per block bf16, {rpb[1]} f32): max |kernel - "
          f"plain| {k1_err:.3e} bf16 MLP (tol {PACK_TOL_BF16}), "
          f"{k1_err32:.3e} f32 MLP on {F32_RAYS} rays (tol {PACK_TOL})",
          flush=True)
    if not (k1_err <= PACK_TOL_BF16 and k1_err32 <= PACK_TOL):
        raise AssertionError(f"n3d K1 disagrees with its plain version: "
                             f"{k1_err}, {k1_err32}")
    del cf32, tabs32
    N = pack.shape[1]
    valid = valid_count(pack)
    print(f"# n3d chunk: {valid} of {N} samples valid "
          f"({100 * valid / N:.1f} %)", flush=True)
    if valid < N // 4:
        raise AssertionError("under a quarter of the samples are valid: "
                             "move the camera")

    lines, wb = prep["lines"], prep["wb"]
    spec = MultiSpec(S=cf.S, axes=axes, deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale)
    lines0 = [premix_time(t, rp[0, 7]) for t in lines]
    axes0 = tuple(dataclasses.replace(a, TH=0) for a in axes)
    spec0 = dataclasses.replace(spec, axes=axes0)
    # the chunk with a t per ray spread over every keyframe interval,
    # beside the frame's one t
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rp_spread = rp.clone()
    rp_spread[:, 7] = 2.0 * torch.rand(N // cf.S, device=dev,
                                       generator=gen) - 1.0
    k5_err = {}
    for name, ls, sp, r in (("TH=12", lines, spec, rp),
                            ("premixed", lines0, spec0, rp),
                            ("TH=12 t spread", lines, spec, rp_spread)):
        out = shade_multi(prep["quads"], ls, pack, r, wb, sp)
        out_p = shade_multi_plain(prep["quads"], ls, pack, r, wb, sp)
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        print(f"# n3d K5 shade_multi {name}: max |kernel - plain| rgb/acc "
              f"{err:.3e}, depth {derr:.3e} (tol {SHADE_TOL}); acc mean "
              f"{out[:, 3].mean().item():.4f}; {k5_launch(shade_multi)}",
              flush=True)
        if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL):
            raise AssertionError(f"n3d K5 ({name}) disagrees with its plain "
                                 f"version: {err}, {derr}")
        k5_err[name] = err
        del out, out_p
    R8 = N3D_PATCH_R8[2]
    frame_pm = phase_major(frame, R8).contiguous()
    chunk_pm = frame_pm[0]
    rp_pm = cf.ray_pack(chunk_pm)
    pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                         .contiguous(), tabs, rp_pm, cf.spec, IT)
    pspecs = model8._cf_eval.patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], True)
    feats, viol_k4, k4_err = k4_check(torch, "n3d", prep8["ptabs"], pack_pm,
                                      pspecs)
    pre = shade_multi_preblended(feats, lines, pack_pm, rp_pm, wb, spec)
    pre_p = shade_multi_preblended_plain(feats, lines, pack_pm, rp_pm, wb,
                                         spec)
    pre_f = folded_errs(pre, shade_multi_preblended_folded_plain(
        feats, lines, pack_pm, rp_pm, wb, spec))
    torch.cuda.synchronize()
    pre_err = (pre[:, :4] - pre_p[:, :4]).abs().max().item()
    del pre_p
    # K6 at R=8 (5, 3) on the phase-major chunk and at R=4 (4, 3) on the
    # chunk in scanline order
    k6 = {}
    pspecs4 = model4._cf_eval.patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], False)
    for name, ptabs, pk, rpk, pss in (
            ("R=8 (5,3)", prep8["ptabs"], pack_pm, rp_pm, pspecs),
            ("R=4 (4,3)", prep4["ptabs"], pack, rp, pspecs4)):
        fused, vk = shade_multi_patch(ptabs, lines, pk, rpk, wb, spec, pss)
        fused_p, vp = shade_multi_patch_plain(ptabs, lines, pk, rpk, wb,
                                              spec, pss)
        fused_f, vf = shade_multi_patch_folded_plain(ptabs, lines, pk, rpk,
                                                     wb, spec, pss)
        quad = shade_multi(prep["quads"], lines, pk, rpk, wb, spec)
        torch.cuda.synchronize()
        err = (fused[:, :4] - fused_p[:, :4]).abs().max().item()
        derr = (fused[:, 4] - fused_p[:, 4]).abs().max().item()
        ferr = folded_errs(fused, fused_f)
        print(f"# n3d K6 shade_multi_patch {name}: max |kernel - plain| "
              f"rgb/acc {err:.3e}, depth {derr:.3e}, - folded plain "
              f"{ferr[0]:.3e}, {ferr[1]:.3e} (tol {SHADE_TOL}); "
              f"violations {int(vk)} (plain {int(vp)}, folded {int(vf)}) of "
              f"{N // pss[0].R} slots; vs K5 "
              f"{(fused[:, :4] - quad[:, :4]).abs().max().item():.3e}; "
              + build_stats("shade_multi_patch_kernel",
                            (pss[0].R, True, False)), flush=True)
        if not (max(err, ferr[0]) <= SHADE_TOL
                and max(derr, ferr[1]) <= 10 * SHADE_TOL
                and int(vk) == int(vp) == int(vf)):
            raise AssertionError(f"n3d K6 ({name}) disagrees with its plain "
                                 f"versions: {err}, {derr}, {ferr}, "
                                 f"{int(vk)}, {int(vp)}, {int(vf)}")
        k6[name] = (err, int(vk))
        del fused, fused_p, fused_f, quad
    print(f"# n3d K5-preblended TH=12: max |kernel - plain| {pre_err:.3e} "
          f"(tol {SHADE_TOL}), - folded plain rgb/acc {pre_f[0]:.3e}, depth "
          f"{pre_f[1]:.3e}; "
          + build_stats("shade_multi_pre_kernel", (2, True, False))
          + f"; violations K4 {viol_k4}, K6 R=8 "
          f"{k6['R=8 (5,3)'][1]}", flush=True)
    if not (max(pre_err, pre_f[0]) <= SHADE_TOL
            and pre_f[1] <= 10 * SHADE_TOL
            and viol_k4 == k6["R=8 (5,3)"][1]):
        raise AssertionError(f"n3d K5-preblended / the witness counts "
                             f"disagree: {pre_err}, {viol_k4}, "
                             f"{k6['R=8 (5,3)'][1]}")
    torch.cuda.empty_cache()

    # the chunk's kernels timed in turns (K1, K5 TH=12, K5 premixed, K4
    # x3, K5-pre, K6 R=8, K6 R=4, and back), 20 calls each time; then
    # each plain version twice
    def blend3():
        return patch_blend(prep8["ptabs"], pack_pm, pspecs)

    kernels = {
        "K1": lambda: pack_build(net_in, tabs, rp, cf.spec, IT),
        "K5 TH=12": lambda: shade_multi(prep["quads"], lines, pack, rp, wb,
                                        spec),
        "K5 premixed": lambda: shade_multi(prep["quads"], lines0, pack, rp,
                                           wb, spec0),
        "K5 TH=12 t spread": lambda: shade_multi(prep["quads"], lines, pack,
                                                 rp_spread, wb, spec),
        "K4x3": blend3,
        "K5-pre": lambda: shade_multi_preblended(feats, lines, pack_pm,
                                                 rp_pm, wb, spec),
        "K6 R=8": lambda: shade_multi_patch(prep8["ptabs"], lines, pack_pm,
                                            rp_pm, wb, spec, pspecs),
        "K6 R=4": lambda: shade_multi_patch(prep4["ptabs"], lines, pack, rp,
                                            wb, spec, pspecs4)}
    turns = {name: [] for name in kernels}
    for name in list(kernels) + list(kernels)[::-1]:
        turns[name].append(cuda_ms(torch, kernels[name], 20))
    print("# n3d chunk, in turns: " + "; ".join(
        f"{name} " + ", ".join(f"{t:.4f}" for t in ts) + " ms"
        for name, ts in turns.items()), flush=True)
    ms = {name: sum(ts) / 2 for name, ts in turns.items()}
    plains = {
        "K1": lambda: pack_build_plain(net_in, tabs, rp, cf.spec, IT),
        "K5 TH=12": lambda: shade_multi_plain(prep["quads"], lines, pack, rp,
                                              wb, spec),
        "K5 premixed": lambda: shade_multi_plain(prep["quads"], lines0, pack,
                                                 rp, wb, spec0),
        "K5 TH=12 t spread": lambda: shade_multi_plain(
            prep["quads"], lines, pack, rp_spread, wb, spec),
        "K4x3": lambda: patch_blend_plain(prep8["ptabs"], pack_pm, pspecs),
        "K5-pre": lambda: shade_multi_preblended_plain(
            feats, lines, pack_pm, rp_pm, wb, spec),
        "K6 R=8": lambda: shade_multi_patch_plain(
            prep8["ptabs"], lines, pack_pm, rp_pm, wb, spec, pspecs),
        "K6 R=4": lambda: shade_multi_patch_plain(
            prep4["ptabs"], lines, pack, rp, wb, spec, pspecs4)}
    plain_ms = {}
    for name, fn in plains.items():
        plain_ms[name] = cuda_ms(torch, fn, 2)
        torch.cuda.empty_cache()

    valid_pm = valid_count(pack_pm)
    out_bytes = CHUNK * 5 * 4
    mlp_ops = 2 * CHUNK * sum(
        p["weight"].numel() for p in
        params["embedding"]["ray_prediction_0"]["net"].values())
    bounds = {"K1": bound(
        nbytes(net_in, rp, pack) + sum(nbytes(l.w, l.b) for l in tabs.layers),
        [(mlp_ops, BF16_OPS_PER_S),
         (N * (k1_tail_ops(cf.S) + K1_CONTRACT_OPS), F32_OPS_PER_S)])}
    # the table bytes: only the rows this chunk reads, each once; the time
    # planes (or their premixed lines) whole
    quad_bytes = sum(rows_bytes(q, quad_rows(pack, a.m0, a.m1, a.W, a.H))
                     for q, a in zip(prep["quads"], axes))
    quad_ops = lambda C: 8 * C + 10                       # noqa: E731
    hat_ops = lambda C: 8 * C + 22                        # noqa: E731
    for name, ls, axs in (("K5 TH=12", lines, axes),
                          ("K5 premixed", lines0, axes0),
                          ("K5 TH=12 t spread", lines, axes)):
        bounds[name] = sh_bound(
            f"n3d {name}", nbytes(pack, rp, *ls) + out_bytes + quad_bytes,
            lambda f: [(valid * multi_ops(axs, quad_ops, fold=f)
                        + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    bounds["K5-pre"] = sh_bound(
        "n3d K5-pre", nbytes(pack_pm, rp_pm, *lines, *feats) + out_bytes,
        lambda f: [(valid_pm * multi_ops(axes, lambda C: C, fold=f)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    bounds["K4x3"] = bound(
        nbytes(pack_pm[:4], *feats) + 4 + sum(
            rows_bytes(t, patch_rows(pack_pm, ps, True))
            for t, ps in zip(prep8["ptabs"], pspecs)),
        [(N * sum(hat_ops(a.C) for a in axes), F32_OPS_PER_S)])
    for name, ptabs, pk, rpk, pss in (
            ("K6 R=8", prep8["ptabs"], pack_pm, rp_pm, pspecs),
            ("K6 R=4", prep4["ptabs"], pack, rp, pspecs4)):
        nv = valid_count(pk)
        bounds[name] = sh_bound(
            f"n3d {name}", nbytes(pk, rpk, *lines) + out_bytes + 4 + sum(
                rows_bytes(t, patch_rows(pk, ps, False))
                for t, ps in zip(ptabs, pss)),
            lambda f: [(nv * multi_ops(axes, hat_ops, fold=f)
                        + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    print(f"# n3d chunk ({card}): " + "; ".join(
        f"{name} {ms[name]:.3f} ms (plain {plain_ms[name]:.3f}, bound "
        f"{bounds[name][0]:.4f} {bounds[name][1]}, share "
        f"{100 * bounds[name][0] / ms[name]:.1f} %"
        + (f", before the redesign {BEFORE_MS['n3d ' + name]:.3f}"
           if "n3d " + name in BEFORE_MS else "") + ")" for name in kernels)
        + f"; {valid_pm} of {N} samples valid; MLP {mlp_ops / 1e9:.1f} "
        f"GFLOP ({mlp_ops / ms['K1'] / 1e9:.1f} TFLOP/s at K1's time); quad "
        f"rows the chunk reads {quad_bytes / 1e6:.1f} of "
        f"{nbytes(*prep['quads']) / 1e6:.1f} MB", flush=True)
    k1_plan(torch, "n3d", cf, tabs, mlp_ops, ms["K1"])
    del feats, pre, pack_pm, pack, lines0, rp_spread
    torch.cuda.empty_cache()

    # ---- 16. the bench frame through model.apply on each route, with one
    # t for the frame (uniform_time: the time planes premixed) and with a
    # t per ray (the same t, but mixed per sample by the TH = 12 kernels)
    def render(m, frames, rkw):
        return [m.apply(params, frames[i], ctx, rkw)
                for i in range(frames.shape[0])]

    n_chunks = frame.shape[0]
    R4 = N3D_PATCH_R4[2]
    frame_pm4 = phase_major(frame, R4).contiguous()
    two = {"patch_blend": n_chunks, "shade_multi_preblended": n_chunks}
    fused_k = {"shade_multi_patch": n_chunks}
    # name: (HYPERREEL_FUSED_PATCH_MULTI, model, frame, render_kwargs,
    # launches per frame, R of the phase-major rays)
    routes = {}
    for ut in (True, False):
        tag = "one t" if ut else "t per ray"
        routes[f"n3d quad, {tag}"] = (
            "0", model, frame, {"cf_prepared": prep, "uniform_time": ut},
            {"shade_multi": n_chunks}, None)
        for kind, env, kern in (("two-kernel", "0", two),
                                ("fused", "1", fused_k)):
            for R, m, pr, fr in ((R8, model8, prep8, frame_pm),
                                 (R4, model4, prep4, frame_pm4)):
                shape = N3D_PATCH_R8 if R == R8 else N3D_PATCH_R4
                routes[f"n3d {kind} patch R={R} {shape[:2]}, {tag}"] = (
                    env, m, fr, {"cf_prepared": pr, "uniform_time": ut,
                                 "rays_phase_major": True}, kern, R)
    counts, rgb_quad = {}, None
    for name, (env, m, frames, rkw, kern, R) in routes.items():
        with EnvVar("HYPERREEL_FUSED_PATCH_MULTI", env):
            reset_counts()
            outs = render(m, frames, rkw)
            torch.cuda.synchronize()
            got = read_counts()
        want = dict.fromkeys(got, 0)
        want.update(pack_build=n_chunks, **kern)
        counts[name] = got
        rgb = torch.cat([scanline(o["rgb"], R) if R else o["rgb"]
                         for o in outs])
        if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                and rgb.max() <= 1 and rgb.shape == (SIDE * SIDE, 3)):
            raise AssertionError(f"{name}: frame rgb is not finite in [0, 1]")
        if got != want:
            raise AssertionError(f"{name}: kernel launches {got}, want {want}")
        ut = rkw["uniform_time"]
        uviol = max(float(o["uniform_time_viol"]) for o in outs) if ut \
            else None
        if (ut and uviol != 0.0) or (not ut and "uniform_time_viol"
                                     in outs[0]):
            raise AssertionError(f"{name}: uniform-time witness {uviol}")
        if rgb_quad is None:
            rgb_quad = rgb
            print(f"# frame {SIDE}x{SIDE} ({name}): rgb min "
                  f"{rgb.min().item():.4f} max {rgb.max().item():.4f} mean "
                  f"{rgb.mean().item():.4f}; launches {got}; uniform-time "
                  f"witness {uviol}", flush=True)
            continue
        err = (rgb - rgb_quad).abs().max().item()
        pviol = max(float(o["patch_coverage_viol"]) for o in outs) if R \
            else 0.0
        print(f"# frame ({name}): launches {got}; coverage witness "
              f"{pviol:.3e} (gate {PVIOL_EXACT}); rgb vs the quad route's "
              f"frame with one t {err:.3e} (tol {PATH_TOL})", flush=True)
        # the frame's footprints stay inside their patches at R=4 (4, 3)
        # (as for llff_z_plane), so those routes must render the quad
        # route's frame; where a witness exceeds the gate it says so
        exact = pviol <= PVIOL_EXACT
        if (R == R4 and not exact) or (exact and not err <= PATH_TOL):
            raise AssertionError(f"{name}: witness {pviol}, rgb error {err}")
    del rgb_quad
    torch.cuda.empty_cache()

    # ---- 17. fused vs general path on 4096 rays with a t per ray, f32 MLP
    # policy
    import copy
    from hyperreel_tpu_torch.models.model import build_model
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"].update(fused_render_cf=False, fused_render=False)
    fused_m = build_model(cfg, dataset_info=n3d_info())
    general = build_model(cfg_g, dataset_info=n3d_info())
    rays = torch.from_numpy(entry_rays(4096)).to(dev)
    a = fused_m.apply(params, rays, ctx)["rgb"]
    b = general.apply(params, rays, ctx)["rgb"]
    path_err = (a - b).abs().max().item()
    print(f"# n3d fused vs general, 4096 entry() rays with a t each: max "
          f"|diff| {path_err:.3e} (tol {PATH_TOL})", flush=True)
    if not path_err <= PATH_TOL:
        raise AssertionError(f"n3d fused and general paths disagree: "
                             f"{path_err}")
    del fused_m, general, a, b

    # ---- 18. frame time of the routes, in turns
    timed = ["n3d quad, one t", "n3d quad, t per ray"] + [
        f"n3d {kind} patch R={sh[2]} {sh[:2]}, one t"
        for sh in (N3D_PATCH_R8, N3D_PATCH_R4)
        for kind in ("fused", "two-kernel")]
    times = {name: [] for name in timed}
    for name in (timed + timed[::-1]) * 2:
        env, m, frames, rkw = routes[name][:4]
        with EnvVar("HYPERREEL_FUSED_PATCH_MULTI", env):
            times[name].append(cuda_ms(
                torch, lambda: render(m, frames, rkw), N3D_TIMED_FRAMES))
    frame_ms = {}
    for name, ts in times.items():
        frame_ms[name] = sum(ts) / len(ts)
        print(f"# {card}: {name} route {frame_ms[name]:.3f} ms/frame, "
              f"{SIDE * SIDE / frame_ms[name] / 1e3:.3f} Mrays/s "
              f"({N3D_TIMED_FRAMES} frames after a warm-up frame, 4 times: "
              + ", ".join(f"{t:.3f}" for t in ts) + ")", flush=True)

    src = "hyperreel_tpu/ops/pallas/"
    t1, t0 = "n3d quad, t per ray", "n3d quad, one t"
    two8 = f"n3d two-kernel patch R={R8} {N3D_PATCH_R8[:2]}, t per ray"
    fu8 = f"n3d fused patch R={R8} {N3D_PATCH_R8[:2]}, t per ray"
    fu4 = f"n3d fused patch R={R4} {N3D_PATCH_R4[:2]}, t per ray"
    rec = [
        ("pack_build_n3d", "pack_build.cuh", "pack_build.py:137", t1,
         "pack_build", k1_err, "K1"),
        ("shade_multi_n3d_time_planes", "shade_multi.cu", "shade.py:742", t1,
         "shade_multi", k5_err["TH=12"], "K5 TH=12"),
        ("shade_multi_n3d_premixed", "shade_multi.cu", "shade.py:742", t0,
         "shade_multi", k5_err["premixed"], "K5 premixed"),
        ("shade_multi_preblended_n3d", "shade_multi.cu", "shade.py:761",
         two8, "shade_multi_preblended", pre_err, "K5-pre"),
        ("patch_blend_n3d_3_planes", "patch_blend.cu", "patch_blend.py:51",
         two8, "patch_blend", k4_err, "K4x3"),
        ("shade_multi_patch_n3d_r8", "shade_multi_patch.cu", "shade.py:786",
         fu8, "shade_multi_patch", k6["R=8 (5,3)"][0], "K6 R=8"),
        ("shade_multi_patch_n3d_r4", "shade_multi_patch.cu", "shade.py:786",
         fu4, "shade_multi_patch", k6["R=4 (4,3)"][0], "K6 R=4")]
    return [entry(name, source, src + line, counts[route][fn], err, ms[key],
                  plain_ms[key], bounds[key])
            for name, source, line, route, fn, err, key in rec], frame_ms


# ---- 44-53. the render-time sample counts

# The sample-count routes at full width: (family, stage, k), the stage
# with_compact_samples(k) ("compact": the first k sorted samples, the
# invalid ones behind the far sentinel) or with_inference_samples(k)
# ("stride": every (S/k)-th sample)
SAMPLE_COUNTS = (("flagship", "compact", 16), ("flagship", "stride", 8),
                 ("flagship", "stride", 16), ("n3d", "stride", 16),
                 ("shiny", "compact", 16))
# K1's least f32 operations per kept sample beside the sort: K1_TAIL_OPS
# without its 15 compare-exchanges of S = 32
K1_KEPT_OPS = K1_TAIL_OPS - 15
COUNT_TIMED_FRAMES = 5


def sample_count_model(cfg, info, stage, k, params, bf16=True, patch=None):
    """The model of `cfg` with the sample-count stage (stage, k), and with
    `patch` the coherent patch-gather route, on `params` with the stage's
    empty params added: (model, params)."""
    import torch

    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.models.model import build_model

    add = presets.with_compact_samples if stage == "compact" \
        else presets.with_inference_samples
    cfg = add(cfg, k)
    if patch:
        cfg = presets.with_coherent_gather(cfg, *patch)
    model = build_model(cfg, dataset_info=info,
                        compute_dtype=torch.bfloat16 if bf16 else None)
    if model._cf_eval is None or model._cf_eval.k != k:
        raise AssertionError(f"{stage} {k}: the channels-first route does "
                             "not take the chain")
    emb = dict(params["embedding"])
    for name, _ in model.embedding.stages:
        emb.setdefault(name, {})
    return model, {**params, "embedding": emb}


def k1_count_ops(params, S, k, P, contract):
    """K1's least operations per ray with k of S samples kept: (bf16
    products: the hidden layers and of the last layer only the columns the
    pack needs, z and sigma of all S samples and the other P - 2 channels
    of the k kept; f32: the sort over S, the tail of the k kept with their
    contraction)."""
    ws = [p["weight"] for p in
          params["embedding"]["ray_prediction_0"]["net"].values()]
    H = ws[-1].shape[1]
    mm = 2 * (sum(w.numel() for w in ws[:-1]) + H * (2 * S + (P - 2) * k))
    n = S.bit_length() - 1
    tail = S * n * (n + 1) // 2 + k * (K1_KEPT_OPS + (K1_CONTRACT_OPS
                                                      if contract else 0))
    return mm, tail


def sample_count_phases(torch, dev, card, frame, reset_counts, read_counts,
                        family, stage, k, base):
    """One sample-count route at full width: K1's branch on one chunk
    against its plain version under both MLP policies; the shade kernels
    at S = k on its pack against their plain versions (the flagship: K2;
    with compaction also K3, K4 and K2-preblended on the phase-major chunk;
    n3d: K5 on the time planes with one t and a t per ray, and premixed;
    shiny: K5 with RGB colour), each timed, its plain version timed and its
    bound with the k samples; the bench frame through model.apply on the
    route's quad route (the flagship with compaction also its two patch
    routes), the launches, the witnesses, the rgb; the flagship with
    compaction also fused vs general path under the f32 MLP policy; the
    frame times in turns with the full-S quad route. `base` = (cfg,
    dataset_info, params) of the family. Returns (the kernels' JSON
    records, {route: ms/frame})."""
    from hyperreel_tpu_torch.configs.presets import with_compact_samples
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.intersect import FAR_SENTINEL
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        pack_build, pack_build_plain, pack_error)
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        patch_blend, patch_blend_plain)
    from hyperreel_tpu_torch.ops.kernels.shade import (
        ShadeSpec, premix_time, shade, shade_plain, shade_preblended,
        shade_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        MultiSpec, shade_multi, shade_multi_plain, shade_multi_preblended,
        shade_multi_preblended_folded_plain, shade_multi_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
        shade_multi_patch, shade_multi_patch_folded_plain,
        shade_multi_patch_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_patch import (
        shade_patch, shade_patch_plain)

    cfg, info, params0 = base
    tag = f"{family}_{stage}{k}"
    ctx = StepCtx(it=IT)
    model, params = sample_count_model(cfg, info, stage, k, params0)
    prep = model.prepare_eval(params)
    cf = model._cf_eval
    S = cf.S
    static = cf.flow is None
    frames = frame[..., :6].contiguous() if static else frame
    print(f"# {tag}: S={S}, k={k}, stride {cf.spec.stride}, far sentinel "
          f"{cf.spec.far_sentinel}", flush=True)

    # ---- one chunk: K1 against its plain version
    chunk = frames[0]
    net_in = cf.pred.net_input(chunk, ctx).float().contiguous()
    rp = cf.ray_pack(chunk)
    tabs = prep["mlp"]
    pack = pack_build(net_in, tabs, rp, cf.spec, IT)
    pack_p = pack_build_plain(net_in, tabs, rp, cf.spec, IT)
    torch.cuda.synchronize()
    k1_err, k1_rel = pack_error(pack, pack_p)
    del pack_p
    m32, _ = sample_count_model(cfg, info, stage, k, params0, bf16=False)
    cf32 = m32._cf_eval
    tabs32 = cf32.prepare(params)["mlp"]
    x32, rp32 = net_in[:F32_RAYS].contiguous(), rp[:F32_RAYS].contiguous()
    k1_err32, k1_rel32 = pack_error(
        pack_build(x32, tabs32, rp32, cf32.spec, IT),
        pack_build_plain(x32, tabs32, rp32, cf32.spec, IT))
    if stage == "compact":
        # the bench camera sees every z-plane ahead, so its kept samples
        # carry no sentinel: the f32 check again with the camera at z =
        # 0.5, among the planes (under the f32 MLP policy both versions do
        # the same f32 math, so no sample crosses dist = 0 in one only)
        inner = chunk[:F32_RAYS].clone()
        inner[:, 2] = 0.5
        x_in = cf32.pred.net_input(inner, ctx).float().contiguous()
        rp_in = cf32.ray_pack(inner)
        pk = pack_build(x_in, tabs32, rp_in, cf32.spec, IT)
        pk_p = pack_build_plain(x_in, tabs32, rp_in, cf32.spec, IT)
        e_in, r_in = pack_error(pk, pk_p)
        share = (pk_p[3] == FAR_SENTINEL).float().mean().item()
        same = torch.equal(pk[3] == FAR_SENTINEL, pk_p[3] == FAR_SENTINEL)
        print(f"# {tag} K1 (f32 MLP) with the camera at z = 0.5: max "
              f"|kernel - plain| {e_in:.3e} (tol {PACK_TOL}), the sentinel "
              f"samples' points relative {r_in:.2e} (tol 1e-6); "
              f"{100 * share:.1f} % of the kept samples at the sentinel, "
              f"the same in both: {same}", flush=True)
        if not (e_in <= PACK_TOL and r_in <= 1e-6 and same and share > 0):
            raise AssertionError(f"{tag} K1 at the sentinel disagrees with "
                                 f"its plain version: {e_in}, {r_in}, "
                                 f"{share}, {same}")
        del inner, x_in, rp_in, pk, pk_p
    del m32, cf32, tabs32
    N = pack.shape[1]
    valid = valid_count(pack)
    sent = (pack[3] == FAR_SENTINEL).sum().item()
    print(f"# {tag} K1 pack_build: max |kernel - plain| {k1_err:.3e} bf16 "
          f"MLP (tol {PACK_TOL_BF16}), {k1_err32:.3e} f32 MLP on {F32_RAYS} "
          f"rays (tol {PACK_TOL}); the sentinel samples' points relative "
          f"{k1_rel:.2e} / {k1_rel32:.2e} (tol 1e-6); pack {N} = {CHUNK} x "
          f"{k} samples, {valid} valid ({100 * valid / N:.1f} %), {sent} at "
          f"the far sentinel", flush=True)
    if not (k1_err <= PACK_TOL_BF16 and k1_err32 <= PACK_TOL
            and k1_rel <= 1e-6 and k1_rel32 <= 1e-6):
        raise AssertionError(f"{tag} K1 disagrees with its plain version: "
                             f"{k1_err}, {k1_err32}, {k1_rel}, {k1_rel32}")
    if valid < N // 4:
        raise AssertionError("under a quarter of the samples are valid")
    mm, tail = k1_count_ops(params, S, k, cf.P,
                            cf.spec.contract.name != "identity")
    bounds = {"K1": bound(
        nbytes(net_in, rp, pack) + sum(nbytes(l.w, l.b)
                                       for l in tabs.layers),
        [(CHUNK * mm, BF16_OPS_PER_S), (CHUNK * tail, F32_OPS_PER_S)])}
    kernels = {"K1": lambda: pack_build(net_in, tabs, rp, cf.spec, IT)}
    plains = {"K1": lambda: pack_build_plain(net_in, tabs, rp, cf.spec, IT)}
    errs = {"K1": k1_err}
    out_bytes = CHUNK * 5 * 4
    rgb_colour = cf.net.shading == "rgb"

    def check(name, out, out_p):
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        finite = bool(torch.isfinite(out).all() and
                      torch.isfinite(out_p).all())
        print(f"# {tag} {name}: max |kernel - plain| rgb/acc {err:.3e}, "
              f"depth {derr:.3e} (tol {SHADE_TOL}); acc mean "
              f"{out[:, 3].mean().item():.4f}; finite {finite}", flush=True)
        if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL and finite):
            raise AssertionError(f"{tag} {name} disagrees with its plain "
                                 f"version: {err}, {derr}, {finite}")
        errs[name] = err

    # ---- the shade kernels at S = k on the chunk's pack
    frame_pm = prep8 = model8 = None
    if cf.dyn1:
        H, W, TH, TW, C, nd = prep["dims"]
        ttab0 = premix_time(prep["ttab"], rp[0, 7])
        spec = ShadeSpec(S=k, W=W, H=H, TW=TW, TH=0, C=C, nd=nd,
                         deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale)
        args = (pack, rp, ttab0, prep["wb"], spec)
        check("K2", shade(prep["quad"], *args), shade_plain(prep["quad"],
                                                            *args))
        spec_t = dataclasses.replace(spec, TH=TH)
        check("K2 TH", shade(prep["quad"], pack, rp, prep["ttab"],
                             prep["wb"], spec_t),
              shade_plain(prep["quad"], pack, rp, prep["ttab"], prep["wb"],
                          spec_t))
        kernels["K2"] = lambda: shade(prep["quad"], *args)
        plains["K2"] = lambda: shade_plain(prep["quad"], *args)
        bounds["K2"] = sh_bound(
            f"{tag} K2", nbytes(pack, rp, ttab0) + out_bytes
            + rows_bytes(prep["quad"], quad_rows(pack, 0, 1, W, H)),
            lambda f: [(valid * (shade_ops(C, nd, fold=f) + 8 * C + 10)
                        + N * COMPOSITE_OPS, F32_OPS_PER_S)], k)
        if stage == "compact":
            # the patch routes' kernels on the chunk in bench.py's
            # phase-major order
            model8, _ = sample_count_model(cfg, info, stage, k, params0,
                                           patch=PATCH_R8)
            prep8 = model8.prepare_eval(params)
            R8 = PATCH_R8[2]
            frame_pm = phase_major(frames, R8).contiguous()
            rp_pm = cf.ray_pack(frame_pm[0])
            pack_pm = pack_build(cf.pred.net_input(frame_pm[0], ctx).float()
                                 .contiguous(), tabs, rp_pm, cf.spec, IT)
            ps8, = model8._cf_eval.patch_specs([(W, H, C, 0, 1)], True)
            pargs = (pack_pm, rp_pm, ttab0, prep["wb"], spec)
            out, vk = shade_patch(prep8["patch"], *pargs, ps8)
            out_p, vp = shade_patch_plain(prep8["patch"], *pargs, ps8)
            check("K3", out, out_p)
            (feats,), fk, errs["K4"] = k4_check(torch, tag, [prep8["patch"]],
                                                pack_pm, [ps8])
            print(f"# {tag} coverage violations K3 {int(vk)} (plain "
                  f"{int(vp)}), K4 {fk} of {N // R8} slots", flush=True)
            if not int(vk) == int(vp) == fk:
                raise AssertionError(f"{tag} K3 / K4 witness counts "
                                     f"disagree: {int(vk)}, {int(vp)}, {fk}")
            check("K2-pre", shade_preblended(feats, *pargs),
                  shade_preblended_plain(feats, *pargs))
            kernels.update({
                "K3": lambda: shade_patch(prep8["patch"], *pargs, ps8),
                "K4": lambda: patch_blend([prep8["patch"]], pack_pm, [ps8]),
                "K2-pre": lambda: shade_preblended(feats, *pargs)})
            plains.update({
                "K3": lambda: shade_patch_plain(prep8["patch"], *pargs, ps8),
                "K4": lambda: patch_blend_plain([prep8["patch"]], pack_pm,
                                                [ps8]),
                "K2-pre": lambda: shade_preblended_plain(feats, *pargs)})
            valid_pm = valid_count(pack_pm)
            bounds["K3"] = sh_bound(
                f"{tag} K3", nbytes(pack_pm, rp_pm, ttab0) + out_bytes + 4
                + rows_bytes(prep8["patch"], patch_rows(pack_pm, ps8,
                                                        False)),
                lambda f: [(valid_pm * (shade_ops(C, nd, fold=f) + 8 * C
                                        + 22) + N * COMPOSITE_OPS,
                            F32_OPS_PER_S)], k)
            bounds["K4"] = bound(
                nbytes(pack_pm[:4], feats) + 4
                + rows_bytes(prep8["patch"], patch_rows(pack_pm, ps8, True)),
                [(N * (8 * C + 22), F32_OPS_PER_S)])
            bounds["K2-pre"] = sh_bound(
                f"{tag} K2-pre", nbytes(feats, pack_pm, rp_pm, ttab0)
                + out_bytes,
                lambda f: [(valid_pm * shade_ops(C, nd, fold=f)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], k)
    else:
        axes, lines, wb = prep["axes"], prep["lines"], prep["wb"]
        spec = MultiSpec(S=k, axes=axes, deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale,
                         shading=cf.net.shading)
        variants = {"K5": (lines, spec, rp)}
        if not static:
            # the time planes (TH = 12) with the frame's one t and with a
            # t per ray spread over every keyframe; premixed for the one t
            gen = torch.Generator(device=dev).manual_seed(SEED)
            rp_spread = rp.clone()
            rp_spread[:, 7] = 2.0 * torch.rand(CHUNK, device=dev,
                                               generator=gen) - 1.0
            spec0 = dataclasses.replace(spec, axes=tuple(
                dataclasses.replace(a, TH=0) for a in axes))
            variants = {
                "K5 premixed": ([premix_time(t, rp[0, 7]) for t in lines],
                                spec0, rp),
                "K5 TH=12": (lines, spec, rp),
                "K5 TH=12 t spread": (lines, spec, rp_spread)}
        quad_bytes = sum(rows_bytes(q, quad_rows(pack, a.m0, a.m1, a.W,
                                                 a.H))
                         for q, a in zip(prep["quads"], axes))
        for name, (ls, sp, r) in variants.items():
            check(name, shade_multi(prep["quads"], ls, pack, r, wb, sp),
                  shade_multi_plain(prep["quads"], ls, pack, r, wb, sp))
            kernels[name] = (lambda ls=ls, sp=sp, r=r: shade_multi(
                prep["quads"], ls, pack, r, wb, sp))
            plains[name] = (lambda ls=ls, sp=sp, r=r: shade_multi_plain(
                prep["quads"], ls, pack, r, wb, sp))
            bounds[name] = sh_bound(
                f"{tag} {name}", nbytes(pack, *ls) + out_bytes + quad_bytes
                + ray_bytes(r, rgb_colour, not static),
                lambda f, sp=sp: [(valid * multi_ops(
                    sp.axes, lambda C: 8 * C + 10, rgb_colour, fold=f)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], k)
        # the multi-axis patch routes' kernels at S = k on the chunk in
        # phase-major order, at the patch that covers the bench frame on
        # the checkpoint grid (n3d: (5, 3) R=8; shiny: (4, 3) R=4): K4 in
        # one launch over the three planes, K5-preblended on its features
        # and K6
        pshape = N3D_PATCH_R8 if family == "n3d" else PATCH_R4
        model8, _ = sample_count_model(cfg, info, stage, k, params0,
                                       patch=pshape)
        prep8 = model8.prepare_eval(params)
        frame_pm = phase_major(frames, pshape[2]).contiguous()
        rp_pm = cf.ray_pack(frame_pm[0])
        pack_pm = pack_build(cf.pred.net_input(frame_pm[0], ctx).float()
                             .contiguous(), tabs, rp_pm, cf.spec, IT)
        pspecs = model8._cf_eval.patch_specs(
            [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], True)
        feats, fk, errs["K4x3"] = k4_check(torch, tag, prep8["ptabs"],
                                           pack_pm, pspecs)
        pargs = (lines, pack_pm, rp_pm, wb, spec)
        pre = shade_multi_preblended(feats, *pargs)
        check("K5-pre", pre, shade_multi_preblended_plain(feats, *pargs))
        check("K5-pre vs folded plain", pre,
              shade_multi_preblended_folded_plain(feats, *pargs))
        fused, vk = shade_multi_patch(prep8["ptabs"], *pargs, pspecs)
        fused_p, vp = shade_multi_patch_plain(prep8["ptabs"], *pargs, pspecs)
        fused_f, vf = shade_multi_patch_folded_plain(prep8["ptabs"], *pargs,
                                                     pspecs)
        check("K6", fused, fused_p)
        check("K6 vs folded plain", fused, fused_f)
        timed = any(a.TH for a in axes)
        print(f"# {tag} coverage violations at {pshape}: K4 {fk}, K6 "
              f"{int(vk)} (plain {int(vp)}, folded {int(vf)}) of "
              f"{N // pshape[2]} slots; K5-pre "
              + build_stats("shade_multi_pre_kernel",
                            (1 if k <= 32 else 2, timed, rgb_colour))
              + "; K6 " + build_stats("shade_multi_patch_kernel",
                                      (pshape[2], timed, rgb_colour)),
              flush=True)
        if not int(vk) == int(vp) == int(vf) == fk:
            raise AssertionError(f"{tag} K4 / K6 witness counts disagree: "
                                 f"{fk}, {int(vk)}, {int(vp)}, {int(vf)}")
        del pre, fused, fused_p, fused_f
        kernels.update({
            "K4x3": lambda: patch_blend(prep8["ptabs"], pack_pm, pspecs),
            "K5-pre": lambda: shade_multi_preblended(feats, *pargs),
            "K6": lambda: shade_multi_patch(prep8["ptabs"], *pargs, pspecs)})
        plains.update({
            "K4x3": lambda: patch_blend_plain(prep8["ptabs"], pack_pm,
                                              pspecs),
            "K5-pre": lambda: shade_multi_preblended_plain(feats, *pargs),
            "K6": lambda: shade_multi_patch_plain(prep8["ptabs"], *pargs,
                                                  pspecs)})
        valid_pm = valid_count(pack_pm)
        shared = (nbytes(pack_pm, *lines) + out_bytes
                  + ray_bytes(rp_pm, rgb_colour, not static))
        ptab_bytes = [sum(rows_bytes(t, patch_rows(pack_pm, ps, every))
                          for t, ps in zip(prep8["ptabs"], pspecs))
                      for every in (False, True)]
        bounds["K4x3"] = bound(
            nbytes(pack_pm[:4], *feats) + ptab_bytes[1] + 4,
            [(N * sum(8 * a.C + 22 for a in axes), F32_OPS_PER_S)])
        bounds["K5-pre"] = sh_bound(
            f"{tag} K5-pre", shared + nbytes(*feats),
            lambda f: [(valid_pm * multi_ops(axes, lambda C: C, rgb_colour,
                                             fold=f)
                        + N * COMPOSITE_OPS, F32_OPS_PER_S)], k)
        bounds["K6"] = sh_bound(
            f"{tag} K6", shared + ptab_bytes[0] + 4,
            lambda f: [(valid_pm * multi_ops(axes, lambda C: 8 * C + 22,
                                             rgb_colour, fold=f)
                        + N * COMPOSITE_OPS, F32_OPS_PER_S)], k)

    # the kernels timed in turns, 20 calls each time; each plain version
    # twice
    turns = {name: [] for name in kernels}
    for name in list(kernels) + list(kernels)[::-1]:
        turns[name].append(cuda_ms(torch, kernels[name], 20))
    ms = {name: sum(ts) / 2 for name, ts in turns.items()}
    plain_ms = {name: cuda_ms(torch, fn, 2) for name, fn in plains.items()}
    print(f"# {tag} chunk ({card}): " + "; ".join(
        f"{name} {ms[name]:.4f} ms (" + ", ".join(
            f"{t:.4f}" for t in turns[name]) + f"; plain "
        f"{plain_ms[name]:.3f}, bound {bounds[name][0]:.4f} "
        f"{bounds[name][1]}, share {100 * bounds[name][0] / ms[name]:.1f} "
        "%" + (f", before the redesign {BEFORE_MS[f'{tag} {name}']:.3f}"
               if f"{tag} {name}" in BEFORE_MS else "") + ")"
        for name in kernels), flush=True)
    del kernels, plains
    torch.cuda.empty_cache()

    # ---- the bench frame through model.apply
    def render(m, fr, rkw):
        return [m.apply(params, fr[i], ctx, rkw) for i in range(fr.shape[0])]

    n_chunks = frames.shape[0]
    kern = "shade" if cf.dyn1 else "shade_multi"
    rk = {"cf_prepared": prep, "uniform_time": True}
    # name: (env variable and value, model, frames, render_kwargs, launches
    # per frame, R of the phase-major rays)
    routes = {f"{tag} quad": (("HYPERREEL_FUSED_PATCH", "1"), model,
                              frames, rk, {kern: n_chunks}, None)}
    if family == "n3d":
        gen = torch.Generator(device=dev).manual_seed(SEED)
        frame_t = frames.clone()
        frame_t[..., 7] = torch.rand(frames.shape[:2], device=dev,
                                     generator=gen)
        routes[f"{tag} quad, t per ray"] = (
            ("HYPERREEL_FUSED_PATCH", "1"), model, frame_t,
            {"cf_prepared": prep}, {kern: n_chunks}, None)
    if model8 is not None:
        rk8 = {"cf_prepared": prep8, "uniform_time": True,
               "rays_phase_major": True}
        routes[f"{tag} fused patch"] = (
            ("HYPERREEL_FUSED_PATCH", "1"), model8, frame_pm, rk8,
            {"shade_patch": n_chunks}, PATCH_R8[2])
        routes[f"{tag} two-kernel patch"] = (
            ("HYPERREEL_FUSED_PATCH", "0"), model8, frame_pm, rk8,
            {"patch_blend": n_chunks, "shade_preblended": n_chunks},
            PATCH_R8[2])
    if model8 is not None and not cf.dyn1:
        rk8 = {"cf_prepared": prep8, "uniform_time": True,
               "rays_phase_major": True}
        two = {"patch_blend": n_chunks, "shade_multi_preblended": n_chunks}
        R = pshape[2]
        routes[f"{tag} two-kernel patch"] = (
            ("HYPERREEL_FUSED_PATCH_MULTI", "0"), model8, frame_pm, rk8, two,
            R)
        routes[f"{tag} fused patch"] = (
            ("HYPERREEL_FUSED_PATCH_MULTI", "1"), model8, frame_pm, rk8,
            {"shade_multi_patch": n_chunks}, R)
        if family == "n3d":
            # K5-preblended on the time planes, mixed per sample at each
            # ray's t (the frame's, as phase 16 takes it: rays of random
            # times advect apart and leave their patches), against the
            # quad route with the planes premixed for that t
            routes[f"{tag} two-kernel patch, time planes"] = (
                ("HYPERREEL_FUSED_PATCH_MULTI", "0"), model8, frame_pm,
                {"cf_prepared": prep8, "rays_phase_major": True}, two, R)
    counts, rgb_quad = {}, {}
    for name, (env, m, fr, rkw, kn, R) in routes.items():
        with EnvVar(*env):
            reset_counts()
            outs = render(m, fr, rkw)
            torch.cuda.synchronize()
            got = read_counts()
        want = dict.fromkeys(got, 0)
        want.update(pack_build=n_chunks, **kn)
        counts[name] = got
        rgb = torch.cat([scanline(o["rgb"], R) if R else o["rgb"]
                         for o in outs])
        if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                and rgb.max() <= 1 and rgb.shape == (SIDE * SIDE, 3)):
            raise AssertionError(f"{name}: frame rgb is not finite in [0, 1]")
        if got != want:
            raise AssertionError(f"{name}: kernel launches {got}, want {want}")
        # the quad frame with the same times
        per_ray = name.endswith("t per ray")
        if R is None:
            rgb_quad.setdefault(per_ray, rgb)
            print(f"# frame {SIDE}x{SIDE} ({name}): rgb min "
                  f"{rgb.min().item():.4f} max {rgb.max().item():.4f} mean "
                  f"{rgb.mean().item():.4f}; launches {got}", flush=True)
            continue
        pviol = max(float(o["patch_coverage_viol"]) for o in outs)
        err = (rgb - rgb_quad[per_ray]).abs().max().item()
        print(f"# frame ({name}, phase-major rays): launches {got}; coverage "
              f"witness {pviol:.3e} (gate {PVIOL_EXACT}); rgb vs the quad "
              f"route's frame {err:.3e} (tol {PATH_TOL})", flush=True)
        if not (pviol <= PVIOL_EXACT and err <= PATH_TOL):
            raise AssertionError(f"{name}: witness {pviol}, rgb error {err}")

    if family == "flagship" and stage == "compact":
        # fused vs general path under the f32 MLP policy (the general chain
        # and the general colour net) on the time plane rounded to bf16
        # (which the general net reads at table precision, the fused route
        # in f32), on entry()'s rays and on rays with their origins among
        # the z-planes (half their kept samples at the far sentinel), over
        # the rays without a sample within FACE_ULPS of an aabb face in K1's
        # pack
        import copy
        cfg_g = copy.deepcopy(cfg)
        cfg_g["color"]["net"].update(fused_render_cf=False,
                                     fused_render=False)
        fused_m, _ = sample_count_model(cfg, info, stage, k, params0,
                                        bf16=False)
        general = build_model(with_compact_samples(cfg_g, k),
                              dataset_info=info)
        rays = torch.from_numpy(entry_rays(4096)).to(dev)
        inner = rays.clone()
        inner[:, 2] = 0.5
        errs_path = []
        pb = bf16_second_factors(torch, params)
        fcf = fused_m._cf_eval
        ftabs = fcf.prepare(pb)["mlp"]
        for r in (rays, inner):
            a = fused_m.apply(pb, r, ctx)["rgb"]
            b = general.apply(pb, r, ctx)["rgb"]
            fpack = pack_build(fcf.pred.net_input(r, ctx).float()
                               .contiguous(), ftabs, fcf.ray_pack(r),
                               fcf.spec, IT)
            keep = ~near_face(torch, fpack, k)
            errs_path.append(((a - b).abs()[keep].max().item(),
                              int((~keep).sum()),
                              (fpack[3] == FAR_SENTINEL).float().mean()
                              .item()))
        print(f"# {tag} fused vs general, f32 MLP: 4096 entry() rays max "
              f"|diff| {errs_path[0][0]:.3e}; with the camera at z = 0.5 "
              f"{errs_path[1][0]:.3e} ({100 * errs_path[1][2]:.1f} % of the "
              f"kept samples at the sentinel; {errs_path[0][1]} / "
              f"{errs_path[1][1]} rays near a face left out) (tol "
              f"{PATH_TOL})", flush=True)
        if not max(e[0] for e in errs_path) <= PATH_TOL:
            raise AssertionError(f"{tag} fused and general paths disagree: "
                                 f"{errs_path}")
        del fused_m, general, pb

    # ---- frame times in turns, with the family's full-S quad route
    full = build_model(cfg, dataset_info=info,
                       compute_dtype=torch.bfloat16)
    full_prep = full.prepare_eval(params0)
    timed = dict(routes)
    timed[f"{family} quad, S={S}, beside {tag}"] = (
        ("HYPERREEL_FUSED_PATCH", "1"), full, frames,
        {"cf_prepared": full_prep, "uniform_time": True}, None, None)
    names = list(timed)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        env, m, fr, rkw = timed[name][:4]
        p = params0 if m is full else params
        with EnvVar(*env):
            times[name].append(cuda_ms(torch, lambda: [
                m.apply(p, fr[i], ctx, rkw) for i in range(fr.shape[0])],
                COUNT_TIMED_FRAMES))
    frame_ms = {}
    for name, ts in times.items():
        frame_ms[name] = sum(ts) / len(ts)
        print(f"# {card}: {name} route {frame_ms[name]:.3f} ms/frame, "
              f"{SIDE * SIDE / frame_ms[name] / 1e3:.3f} Mrays/s "
              f"({COUNT_TIMED_FRAMES} frames after a warm-up frame, twice: "
              + ", ".join(f"{t:.3f}" for t in ts) + ")", flush=True)
    del full, full_prep, pack, model, prep, model8, prep8, frame_pm
    torch.cuda.empty_cache()

    src = "hyperreel_tpu/ops/pallas/"
    quad = f"{tag} quad"
    rec = [("pack_build", "pack_build.cuh", "pack_build.py:137", quad,
            "pack_build", "K1")]
    if cf.dyn1:
        rec.append(("shade", "shade.cu", "shade.py:238", quad, "shade",
                    "K2"))
        if stage == "compact":
            rec += [("shade_patch", "shade_patch.cuh", "shade.py:282",
                     f"{tag} fused patch", "shade_patch", "K3"),
                    ("patch_blend", "patch_blend.cu", "patch_blend.py:51",
                     f"{tag} two-kernel patch", "patch_blend", "K4"),
                    ("shade_preblended", "shade.cu", "shade.py:259",
                     f"{tag} two-kernel patch", "shade_preblended",
                     "K2-pre")]
    elif static:
        rec.append(("shade_multi_rgb", "shade_multi.cu", "shade.py:742",
                    quad, "shade_multi", "K5"))
    else:
        rec += [("shade_multi_premixed", "shade_multi.cu", "shade.py:742",
                 quad, "shade_multi", "K5 premixed"),
                ("shade_multi_time_planes", "shade_multi.cu",
                 "shade.py:742", f"{tag} quad, t per ray", "shade_multi",
                 "K5 TH=12")]
    if not cf.dyn1:
        rec += [("patch_blend_3_planes", "patch_blend.cu",
                 "patch_blend.py:51", f"{tag} two-kernel patch",
                 "patch_blend", "K4x3"),
                ("shade_multi_preblended", "shade_multi.cu", "shade.py:761",
                 f"{tag} two-kernel patch", "shade_multi_preblended",
                 "K5-pre"),
                ("shade_multi_patch", "shade_multi_patch.cu",
                 "shade.py:786", f"{tag} fused patch", "shade_multi_patch",
                 "K6")]
    return [entry(f"{name}_{tag}", source, src + line, counts[route][fn],
                  errs[key], ms[key], plain_ms[key], bounds[key])
            for name, source, line, route, fn, key in rec], frame_ms


def patch_model(cfg, info, params, shape):
    """The flagship with the coherent patch-gather route (px, py, R) on the
    same weights: (model, prepared tables)."""
    import torch

    from hyperreel_tpu_torch.configs.presets import with_coherent_gather
    from hyperreel_tpu_torch.models.model import build_model

    model = build_model(with_coherent_gather(cfg, *shape), dataset_info=info,
                        compute_dtype=torch.bfloat16)
    return model, model.prepare_eval(params)


class EnvVar:
    """Set one environment variable for the duration of a with-block."""

    def __init__(self, name, value):
        self.name, self.value, self.old = name, value, None

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


def bf16_ulp(torch, x):
    """One bf16 ulp of each value (2^(exponent - 7))."""
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


def k4_check(torch, tag, ptabs, pack, specs):
    """K4's one launch over the planes of `specs` against its plain
    version: each plane's features within one bf16 ulp of their value
    (the same f32 sum in another order, then rounded; 1e-6 where it
    cancels), the counts of violating slots equal. Returns (the features,
    the count, the largest |difference|)."""
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        patch_blend, patch_blend_plain)
    feats, vk = patch_blend(ptabs, pack, specs)
    feats_p, vp = patch_blend_plain(ptabs, pack, specs)
    errs, ratios = [], []
    for f, fp in zip(feats, feats_p):
        fk, fpl = f.float(), fp.float()
        errs.append((fk - fpl).abs().max().item())
        ratios.append(((fk - fpl).abs() / (bf16_ulp(torch, torch.maximum(
            fk.abs(), fpl.abs())) + 1e-6)).max().item())
        del fk, fpl
    print(f"# {tag} K4 patch_blend, {len(specs)} plane(s) in one launch: "
          "max |kernel - plain| " + ", ".join(
              f"({s.m0}, {s.m1}) C={s.C} {e:.3e} ({r:.3f} bf16 ulps)"
              for s, e, r in zip(specs, errs, ratios))
          + f" (tol 1 ulp); violations {int(vk)} (plain {int(vp)}) of "
          f"{pack.shape[1] // specs[0].R} slots", flush=True)
    if not (max(ratios) <= 1.0 and int(vk) == int(vp)):
        raise AssertionError(f"{tag} K4 disagrees with its plain version: "
                             f"{ratios}, {int(vk)} vs {int(vp)}")
    return feats, int(vk), max(errs)


# ---- 54-57: the flagship's training step (hyperreel_tpu_torch/train/)
# the blob scene the trainer fits: 16 views of 128^2 rays at 8 frames
# (2,097,152 rays, 128 batches of DEFAULT_TRAINING's 16,384), marched on
# the card
TRAIN_SCENE = {"n_views": 16, "wh": (128, 128), "dynamic": True,
               "num_frames": 8, "num_keyframes": 4}
TRAIN_STEPS = 60
TRAIN_ALPHA_IT = 20             # the alpha-mask event (the preset: 4000)
TRAIN_UPSAMPLE_IT = 30          # the first upsample (the preset: 4000)
TRAIN_TIMED = 20                # steps timed per grid, after one warm-up
TRAIN_SPLIT = 10                # steps timed piece by piece
TRAIN_PROFILED = 3              # steps under torch.profiler
# the box the net shrinks to if the alpha event left the aabb where it was
# (its z faces on no z-plane anchor of the 32)
TRAIN_SHRUNK = [[-1.8, -1.8, -0.9], [1.8, 1.8, 0.9]]
def training_setup(torch, dev):
    """The flagship at full width (bf16 MLP policy) with its grid events
    moved early, DEFAULT_TRAINING and tv_4000_defaults, on the blob scene
    marched on the card: (cfg, scene, trainer)."""
    import copy

    from hyperreel_tpu_torch.config import DEFAULT_TRAINING
    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, technicolor_z_plane)
    from hyperreel_tpu_torch.data.synthetic import gaussian_blob_scene
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.trainer import Trainer

    cfg = convert_epochs_to_iters(technicolor_z_plane(), iters_per_epoch=4000)
    net = cfg["color"]["net"]
    # the events early; the upsample keeps the preset's schedule of five,
    # so that it goes to the schedule's first voxel count
    net["update_AlphaMask_list"] = [TRAIN_ALPHA_IT]
    net["upsamp_list"] = [TRAIN_UPSAMPLE_IT] + net["upsamp_list"][1:]
    t0 = time.perf_counter()
    ds = gaussian_blob_scene(**TRAIN_SCENE, device=dev)
    print(f"# blob scene: {ds.num_rays} rays ({ds.num_images} images of "
          f"{TRAIN_SCENE['wh']}) marched in {time.perf_counter() - t0:.2f} s",
          flush=True)
    model = build_model(copy.deepcopy(cfg), dataset_info=ds.info(),
                        compute_dtype=torch.bfloat16)
    trainer = Trainer(model, copy.deepcopy(DEFAULT_TRAINING),
                      regularizer_cfgs=tv_4000_defaults(),
                      iters_per_epoch=4000, device=dev)
    return cfg, ds, trainer


def grads_finite(torch, grads):
    return bool(torch.stack([torch.isfinite(g).all()
                             for g in grads.values()]).all())


def params_finite(torch, params):
    from hyperreel_tpu_torch.train.optim import tree_leaves
    return bool(torch.stack([torch.isfinite(v).all()
                             for _, v in tree_leaves(params)]).all())


def time_steps(torch, trainer, state, ds, tag):
    """ms per step over TRAIN_TIMED steps (CUDA events, the batch's copy
    to the card included) after one warm-up step; the forward, backward
    and optimizer split over TRAIN_SPLIT more (CUDA events between the
    trainer's own calls that make up its step: Trainer.forward,
    Trainer.backward, the optimizer's step); the device time of the lookups' backward and of the whole
    step from torch.profiler over TRAIN_PROFILED more; the peak of
    allocated memory. On a copy of `state`."""
    import copy

    state = copy.deepcopy(state)
    opt = trainer.make_optimizer(state.params)
    batches = ds.batch_iterator(trainer.training_cfg["batch_size"],
                                seed=SEED + 7)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = trainer.step(state, trainer.to_device(next(batches)), opt,
                            gen)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_TIMED):
        state, m = trainer.step(state, trainer.to_device(next(batches)),
                                opt, gen)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_TIMED
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated()
    if not (params_finite(torch, state.params)
            and all(torch.isfinite(v).item() for v in m.values())):
        raise AssertionError(f"{tag}: a timed step is not finite")

    split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(TRAIN_SPLIT):
        batch = trainer.to_device(next(batches))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, _, leaves = trainer.forward(
            state.params, batch, trainer.step_ctx(state.it, gen))
        ev[1].record()
        grads = trainer.backward(total, leaves)
        ev[2].record()
        opt.step(state.params, grads, state.opt_state)
        ev[3].record()
        torch.cuda.synchronize()
        if not grads_finite(torch, grads):
            raise AssertionError(f"{tag}: a gradient is not finite")
        for k, a, b in zip(split, ev, ev[1:]):
            split[k] += a.elapsed_time(b) / TRAIN_SPLIT
        state = type(state)(state.params, state.opt_state, state.it + 1)
        del total, leaves, grads

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRAIN_PROFILED):
            state, _ = trainer.step(
                state, trainer.to_device(next(batches)), opt, gen)
        torch.cuda.synchronize()

    def dev_us(e, self_only):
        names = ("self_device_time_total", "self_cuda_time_total") \
            if self_only else ("device_time_total", "cuda_time_total")
        for n in names:
            if hasattr(e, n):
                return getattr(e, n)
        return 0.0

    from torch.autograd import DeviceType
    ka = prof.key_averages()
    # the busy time sums the kernels' own rows: an operator's row carries
    # the device time of the kernels it launched too, so summing every row
    # counts each kernel twice
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e, True) for e in kernels) / 1e3 / TRAIN_PROFILED
    lookup_bwd, line_bwd = (
        sum(dev_us(e, False) for e in ka if name in e.key) / 1e3
        / TRAIN_PROFILED for name in ("_Quad2dBackward", "_Quad1dBackward"))
    top = sorted(kernels, key=lambda e: -dev_us(e, True))[:8]
    print(f"# {tag}: step {step_ms:.3f} ms (CUDA events over {TRAIN_TIMED} "
          f"steps; host {host_ms:.3f} ms); forward {split['forward']:.3f}, "
          f"backward {split['backward']:.3f}, optimizer "
          f"{split['optimizer']:.3f} ms; peak allocated {peak / 2**30:.3f} "
          f"GiB", flush=True)
    if busy > 0:
        print(f"# {tag} profile: device busy {busy:.3f} ms per step, the "
              f"lookups' backward: planes (_Quad2dBackward) "
              f"{lookup_bwd:.3f} ms ({100 * lookup_bwd / busy:.1f} %), "
              f"lines (_Quad1dBackward) {line_bwd:.3f} ms "
              f"({100 * line_bwd / busy:.1f} %); top kernels by device "
              "time per step: " + "; ".join(
                  f"{e.key[:60]} {dev_us(e, True) / 1e3 / TRAIN_PROFILED:.3f}"
                  for e in top), flush=True)
    else:
        print(f"# {tag} profile: no device time in the trace (not measured)",
              flush=True)
        busy = lookup_bwd = line_bwd = None
    return {"step_ms": step_ms, "host_ms": host_ms, "split_ms": split,
            "busy_ms": busy, "lookup_backward_ms": lookup_bwd,
            "line_backward_ms": line_bwd, "peak_bytes": peak}


def bf16_colour_gate(torch, pack, pack_p, label, far_sentinel, skip=None):
    """K1 under the bf16 MLP policy on trained weights, against its plain
    version by pack row. Rows 0-3 (the points and the sorted distance)
    within PACK_TOL_BF16, as in every phase. Rows 4-9 (the colour scale
    and shift, the MLP's last layer read at each sample slot; the sort
    does not permute them): the two versions sum the same bf16 products in
    another order, so a hidden activation may round to the neighbouring
    bf16 value on one side, and trained weights carry that ulp into the
    colour fields further than PACK_TOL_BF16. So at most BF16_MOVED_SHARE
    of the samples may move more than 1e-3 there, and no element more
    than BF16_COLOUR_ULPS bf16 ulps of max(|plain|, 1). A kernel that is
    wrong on a whole block, a row or a field fails one of the three.
    `skip`: rays whose rows 0-3 sentinel_flips holds instead. Prints the
    rows' errors; returns whether the gate passed."""
    d = (pack - pack_p).abs()
    far = pack_p[3] == far_sentinel
    d[:3, far] = 0.0             # pack_error holds these points relatively
    if skip is not None:
        d[:4, skip.repeat_interleave(d.shape[1] // skip.shape[0])] = 0.0
    geo = d[:4].amax().item()
    col = d[4:]
    cap = BF16_COLOUR_ULPS * 2.0 ** -8 * pack_p[4:].abs().clamp_min(1.0)
    over = int((col > cap).sum())
    moved = int((col.amax(0) > 1e-3).sum())
    share = moved / col.shape[1]
    worst = int(col.argmax())
    r, c = divmod(worst, col.shape[1])
    print(f"# the {label} model's chunk: K1 under bf16 by pack row "
          + " ".join(f"{e:.1e}" for e in d.amax(1).tolist())
          + f"; rows 0-3 {geo:.3e} (tol {PACK_TOL_BF16}); colour rows: "
          f"{moved} of {col.shape[1]} samples moved > 1e-3 ({share:.4%}, "
          f"gate {BF16_MOVED_SHARE:.1%}), the largest {col.max().item():.3e}"
          f" at row {4 + r} where plain is {pack_p[4 + r, c].item():.4f}, "
          f"{over} elements over {BF16_COLOUR_ULPS} bf16 ulps of "
          "max(|plain|, 1)", flush=True)
    return geo <= PACK_TOL_BF16 and share <= BF16_MOVED_SHARE and over == 0


def trained_flagship_chunk(torch, model, params, chunk, ctx, prep, label,
                           model32=None):
    """One chunk of a trained flagship (`prep`: its prepared tables): K1
    against its plain version (PACK_TOL_BF16), K2 on the time planes and
    premixed (TH=0) against its plain version (SHADE_TOL on rgb/acc, ten
    times that on depth), both timed with their plain versions (K2 at
    TH=0), and their bounds. With `model32` (the model under the f32 MLP
    policy, where both versions do the same f32 math), K1 is also held
    against its plain version on F32_RAYS of the chunk's rays under that
    policy (PACK_TOL), and K1's bf16 gate is split by pack row
    (bf16_colour_gate): trained weights amplify a one-ulp flip of a hidden
    activation into the colour fields past PACK_TOL_BF16. A ray whose
    camera sees a sample within rounding of distance 0 may have it valid
    on one side and at the far sentinel on the other: such rays, at most
    FLIP_SHARE of them, are held by sentinel_flips at the same tolerance.
    Returns ((K1 error, ms, plain ms, bound), the same of K2)."""
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        FAR_SENTINEL, pack_build, pack_build_plain, pack_error,
        sentinel_flips)
    from hyperreel_tpu_torch.ops.kernels.shade import (
        ShadeSpec, premix_time, shade, shade_plain)

    def k1_error(pack, pack_p, rp, spec, tol, what):
        """pack_error with the rays of sentinel_flips held by it: (error,
        the sentinel points' relative error, the flipped rays, gate)."""
        flips, flip_err = sentinel_flips(pack, pack_p, rp, spec, tol)
        err, rel = pack_error(pack, pack_p, skip=flips)
        err, n = max(err, flip_err), int(flips.sum())
        print(f"# the {label} model's chunk: K1 {what}: {n} of "
              f"{flips.shape[0]} rays with a sample within rounding of "
              f"distance 0 on one side only (gate {FLIP_SHARE:.1%}), held "
              f"shifted to {flip_err:.3e} (tol {tol})", flush=True)
        return err, rel, flips, (n <= FLIP_SHARE * flips.shape[0]
                                 and flip_err <= tol)

    cf, net = model._cf_eval, model.color_net
    B = chunk.shape[0]
    net_in = cf.pred.net_input(chunk, ctx).float().contiguous()
    rp = cf.ray_pack(chunk)
    tabs = prep["mlp"]
    pack = pack_build(net_in, tabs, rp, cf.spec, ctx.it)
    pack_p = pack_build_plain(net_in, tabs, rp, cf.spec, ctx.it)
    torch.cuda.synchronize()
    # a model that sorts invalid samples far: their points at the far
    # sentinel compared relatively (pack_error)
    k1_err, k1_rel, flips, flip_gate = k1_error(
        pack, pack_p, rp, cf.spec, PACK_TOL_BF16, "under bf16")
    k1_gate = k1_err <= PACK_TOL_BF16 and flip_gate
    if model32 is not None:
        k1_gate = flip_gate and bf16_colour_gate(
            torch, pack, pack_p, label, FAR_SENTINEL, flips)
        cf32 = model32._cf_eval
        x32 = net_in[:F32_RAYS].contiguous()
        rp32 = rp[:F32_RAYS].contiguous()
        tabs32 = cf32.prepare(params)["mlp"]
        k1_err32, k1_rel32, _, flip_gate32 = k1_error(
            pack_build(x32, tabs32, rp32, cf32.spec, ctx.it),
            pack_build_plain(x32, tabs32, rp32, cf32.spec, ctx.it),
            rp32, cf32.spec, PACK_TOL, "under the f32 MLP policy")
        print(f"# the {label} model's chunk: K1 under the f32 MLP policy "
              f"({F32_RAYS} rays) max |kernel - plain| {k1_err32:.3e} (tol "
              f"{PACK_TOL}; the far sentinel's points relative "
              f"{k1_rel32:.2e})", flush=True)
        k1_gate = k1_gate and k1_err32 <= PACK_TOL and k1_rel32 <= 1e-6 \
            and flip_gate32
        del tabs32
    del pack_p
    H, W, TH, TW, C, nd = prep["dims"]
    k2_err, spec0 = 0.0, None
    for th in (TH, 0):
        ttab = prep["ttab"] if th else premix_time(prep["ttab"], rp[0, 7])
        spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=th, C=C, nd=nd,
                         deg=net.sh_deg, distance_scale=net.distance_scale)
        out = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        out_p = shade_plain(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL):
            raise AssertionError(f"{label} K2 disagrees with its plain "
                                 f"version (TH={th}): {err}, {derr}")
        k2_err = max(k2_err, err)
        spec0 = (ttab, spec)
    print(f"# the {label} model's chunk: K1 max |kernel - plain| "
          f"{k1_err:.3e} (tol {PACK_TOL_BF16}"
          f"{' on rows 0-3' if model32 is not None else ''}; the far "
          "sentinel's points "
          f"relative {k1_rel:.2e}, tol 1e-6), K2 {k2_err:.3e} (tol "
          f"{SHADE_TOL}); grid {H}x{W}, time plane {TH}x{TW}, aabb "
          f"{np.asarray(net.aabb).tolist()}; acc mean "
          f"{out[:, 3].mean().item():.4f}", flush=True)
    if not (k1_gate and k1_rel <= 1e-6):
        raise AssertionError(f"{label} K1 disagrees with its plain version: "
                             f"{k1_err}, {k1_rel}")
    ttab, spec = spec0
    k1_ms = cuda_ms(torch, lambda: pack_build(net_in, tabs, rp, cf.spec,
                                              ctx.it), 20)
    k1_plain_ms = cuda_ms(torch, lambda: pack_build_plain(
        net_in, tabs, rp, cf.spec, ctx.it), 3)
    k2_ms = cuda_ms(torch, lambda: shade(prep["quad"], pack, rp, ttab,
                                         prep["wb"], spec), 20)
    k2_plain_ms = cuda_ms(torch, lambda: shade_plain(
        prep["quad"], pack, rp, ttab, prep["wb"], spec), 3)
    N = pack.shape[1]
    valid = valid_count(pack)
    mlp_ops = 2 * B * sum(
        p["weight"].numel() for p in
        params["embedding"]["ray_prediction_0"]["net"].values())
    k1_bound = bound(
        nbytes(net_in, rp, pack) + sum(nbytes(l.w, l.b) for l in tabs.layers),
        [(mlp_ops, BF16_OPS_PER_S), (N * K1_TAIL_OPS, F32_OPS_PER_S)])
    k2_bound = sh_bound(
        f"{label} K2", nbytes(pack, rp, ttab) + B * 5 * 4
        + rows_bytes(prep["quad"], quad_rows(pack, 0, 1, W, H)),
        lambda f: [(valid * (shade_ops(C, nd, fold=f) + 8 * C + 10)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    print(f"# the {label} model's chunk: {valid} of {N} samples valid; "
          f"K1 {k1_ms:.3f} ms (plain {k1_plain_ms:.3f}, bound "
          f"{k1_bound[0]:.4f}), K2 TH=0 {k2_ms:.3f} ms (plain "
          f"{k2_plain_ms:.3f}, bound {k2_bound[0]:.4f})", flush=True)
    return ((k1_err, k1_ms, k1_plain_ms, k1_bound),
            (k2_err, k2_ms, k2_plain_ms, k2_bound))


def flagship_entries(label, counts, k1, k2):
    """The JSON records of a trained flagship's K1 and K2 (`counts`: the
    launches of its frame; k1, k2: trained_flagship_chunk's)."""
    return [entry(f"pack_build_{label}", "pack_build.cuh",
                  "hyperreel_tpu/ops/pallas/pack_build.py:137",
                  counts["pack_build"], *k1),
            entry(f"shade_{label}", "shade.cu",
                  "hyperreel_tpu/ops/pallas/shade.py:238", counts["shade"],
                  *k2)]


def training_phases(torch, dev, card, frame, reset_counts, read_counts):
    """Phases 54-57: train the flagship at full width across an alpha-mask
    event and an upsample, time its step, render the trained model through
    K1 and K2, and resume it from a checkpoint. Returns (the two kernels'
    JSON records, the training record)."""
    import copy

    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.models.tensorf import n_to_reso
    from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build
    from hyperreel_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from hyperreel_tpu_torch.train.metrics import psnr
    from hyperreel_tpu_torch.train.optim import tree_leaves
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.trainer import Trainer

    # ---- 54. train 60 steps across the alpha-mask event and the upsample
    cfg, ds, trainer = training_setup(torch, dev)
    model, net = trainer.model, trainer.model.color_net
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    state0 = copy.deepcopy(state)
    grid0, aabb0 = list(net.grid_size), net.aabb.copy()
    event_s = {}
    apply_event = trainer.apply_event

    def timed_event(st, it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply_event(st, it)
        torch.cuda.synchronize()
        event_s[it] = time.perf_counter() - t0
        return out

    trainer.apply_event = timed_event
    batches = ds.batch_iterator(trainer.training_cfg["batch_size"],
                                seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    half = (TRAIN_ALPHA_IT + TRAIN_UPSAMPLE_IT) // 2
    state, hist = trainer.fit(state, batches, half, gen=gen, log_every=1)
    counts_alpha = dict(state.opt_state["count"])
    aabb1 = net.aabb.copy()
    state, hist2 = trainer.fit(state, batches, TRAIN_STEPS - half, gen=gen,
                               log_every=1)
    hist += hist2
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    trainer.apply_event = apply_event
    losses = [h["image_loss"] for h in hist]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    want_grid = n_to_reso(net.n_voxel_list[0], net.aabb)
    moved = not np.array_equal(aabb1, aabb0)
    print(f"# 54. {TRAIN_STEPS} steps in {fit_s:.2f} s: image loss first 5 "
          f"{first:.5f}, last 5 {last:.5f}; psnr {hist[0]['psnr']:.2f} -> "
          f"{hist[-1]['psnr']:.2f}; grid {grid0} -> {net.grid_size} (want "
          f"{want_grid}); the alpha event at {TRAIN_ALPHA_IT} "
          f"{'moved' if moved else 'left'} the aabb {aabb0.tolist()} -> "
          f"{aabb1.tolist()}; optimizer counters {counts_alpha} after it, "
          f"{state.opt_state['count']} at the end; events (wall s) "
          f"{ {k: round(v, 3) for k, v in event_s.items()} }", flush=True)
    groups = set(state.opt_state["count"])
    if not (all(np.isfinite(h[k]) for h in hist for k in h)
            and params_finite(torch, state.params)):
        raise AssertionError("training: a loss or a param is not finite")
    if not last < first:
        raise AssertionError(f"training: the image loss did not fall "
                             f"({first} -> {last})")
    if net.grid_size != want_grid or state.it != TRAIN_STEPS:
        raise AssertionError(f"training: grid {net.grid_size}, want "
                             f"{want_grid}; it {state.it}")
    if counts_alpha != dict.fromkeys(groups, half - TRAIN_ALPHA_IT) or \
            state.opt_state["count"] != dict.fromkeys(
                groups, TRAIN_STEPS - TRAIN_UPSAMPLE_IT):
        raise AssertionError("training: the optimizer's counters did not "
                             "restart at the events")
    if sorted(event_s) != [TRAIN_ALPHA_IT, TRAIN_UPSAMPLE_IT]:
        raise AssertionError(f"training: events at {sorted(event_s)}")
    if not moved:
        net.shrink(state.params["color"], np.asarray(TRAIN_SHRUNK))
        print(f"# the net shrunk to {TRAIN_SHRUNK} by hand", flush=True)

    # ---- 55. the step's time on the initial and the upsampled grid
    aabb_now, net.aabb = net.aabb, aabb0     # the initial state's box
    timing = {"initial": time_steps(torch, trainer, state0, ds,
                                    f"55. step on the initial grid {grid0}")}
    net.aabb = aabb_now
    upsampled = list(net.grid_size)
    timing["upsampled"] = time_steps(
        torch, trainer, state, ds, f"55. step on the upsampled grid "
        f"{upsampled}")
    del state0
    torch.cuda.empty_cache()

    # ---- 56. the trained model through K1 and K2
    ctx = StepCtx(it=state.it)
    with torch.no_grad():
        prep = model.prepare_eval(state.params)
        rk = {"cf_prepared": prep, "uniform_time": True}
        reset_counts()
        outs = [model.apply(state.params, frame[i], ctx, rk)
                for i in range(frame.shape[0])]
        torch.cuda.synchronize()
        counts = read_counts()
        rgb = torch.cat([o["rgb"] for o in outs])
        want = dict.fromkeys(counts, 0)
        want.update(pack_build=frame.shape[0], shade=frame.shape[0])
        print(f"# 56. the trained model's bench frame (quad route): rgb "
              f"min {rgb.min().item():.4f} max {rgb.max().item():.4f} mean "
              f"{rgb.mean().item():.4f}; launches {counts}", flush=True)
        if counts != want:
            raise AssertionError(f"trained frame: launches {counts}, want "
                                 f"{want}")
        if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                and rgb.max() <= 1):
            raise AssertionError("trained frame: rgb not finite in [0, 1]")
        view = ds.image(3)
        vr = model.apply(state.params, torch.from_numpy(view["rays"]).to(dev),
                         ctx, {"cf_prepared": prep})["rgb"]
        print(f"# the trained model on training view 3 (quad route): psnr "
              f"{psnr(vr, torch.from_numpy(view['rgb']).to(dev)).item():.3f}"
              " dB", flush=True)

        k1, k2 = trained_flagship_chunk(torch, model, state.params, frame[0],
                                        ctx, prep, "trained")
        del outs, prep
        torch.cuda.empty_cache()

        # fused against the general path, f32 MLP policy
        cfg_g = copy.deepcopy(cfg)
        cfg_g["color"]["net"].update(fused_render_cf=False,
                                     fused_render=False)
        fused = build_model(copy.deepcopy(cfg), dataset_info=ds.info())
        general = build_model(cfg_g, dataset_info=ds.info())
        for m in (fused, general):
            m.color_net.grid_size = list(net.grid_size)
            m.color_net.aabb = np.array(net.aabb)
        # the time planes rounded to bf16: the general net reads them at
        # table precision, K2 in f32 (as in phases 41-43)
        p16 = bf16_second_factors(torch, state.params)
        rays = torch.from_numpy(entry_rays(4096)).to(dev)
        a = fused.apply(p16, rays, ctx)["rgb"]
        b = general.apply(p16, rays, ctx)["rgb"]
        fcf = fused._cf_eval
        fpack = pack_build(fcf.pred.net_input(rays, ctx).float().contiguous(),
                           fcf.prepare(p16)["mlp"],
                           fcf.ray_pack(rays), fcf.spec, ctx.it)
        near = near_face(torch, fpack, fcf.S)
        path_err = (a - b).abs()[~near].max().item()
        print(f"# the trained model, fused vs general (f32 MLP), 4096 "
              f"entry() rays: max |diff| {path_err:.3e} (tol {PATH_TOL}) "
              f"over the rays without a sample within {FACE_ULPS} ulps of "
              f"an aabb face ({int(near.sum())} left out); with them "
              f"{(a - b).abs().max().item():.3e}", flush=True)
        if not path_err <= PATH_TOL:
            raise AssertionError(f"trained model: fused and general paths "
                                 f"disagree: {path_err}")
        del fused, general, fpack, p16

    # ---- 57. save, restore into a fresh trainer, one step each
    ckpt = os.path.join("build", "chip_smoke_ckpt")
    save_checkpoint(ckpt, state, model)
    fresh = build_model(copy.deepcopy(cfg), dataset_info=ds.info(),
                        compute_dtype=torch.bfloat16)
    trainer2 = Trainer(fresh, trainer.training_cfg,
                       regularizer_cfgs=tv_4000_defaults(),
                       iters_per_epoch=4000, device=dev)
    state2 = restore_checkpoint(ckpt, trainer2)
    if fresh.color_net.grid_size != net.grid_size or not np.array_equal(
            fresh.color_net.aabb, net.aabb) or state2.it != state.it:
        raise AssertionError("restore: grid, aabb or iteration differ")
    batch = next(batches)
    draws = {"background": 0.25}
    # torch's deterministic index_add_ (and gather and index backward) for
    # these two steps: its atomics would sum the grid gradients in any
    # order; an op without a deterministic form raises
    torch.use_deterministic_algorithms(True)
    try:
        state, m1 = trainer.step(state, trainer.to_device(batch),
                                 trainer.make_optimizer(state.params),
                                 draws=draws)
        state2, m2 = trainer2.step(state2, trainer2.to_device(batch),
                                   trainer2.make_optimizer(state2.params),
                                   draws=draws)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    p2 = dict(tree_leaves(state2.params))
    resume_err = max((p2[p] - v).abs().max().item()
                     for p, v in tree_leaves(state.params))
    resume_ok = all(torch.equal(p2[p], v)
                    for p, v in tree_leaves(state.params))
    print(f"# 57. resumed step: loss {m2['loss'].item():.9g} vs "
          f"{m1['loss'].item():.9g}; params max |diff| {resume_err:.3e} "
          f"(equal to the bit: {resume_ok}); counters "
          f"{state2.opt_state['count']}", flush=True)
    if not (m1["loss"].item() == m2["loss"].item() and resume_ok
            and state2.opt_state["count"] == state.opt_state["count"]):
        raise AssertionError("the resumed step differs from the "
                             "uninterrupted one")
    record = {"grid": [grid0, list(net.grid_size)],
              "aabb": [aabb0.tolist(), np.asarray(net.aabb).tolist()],
              "shrink_by_event": moved, "event_s": event_s,
              "image_loss_first5_last5": [first, last],
              "step": timing, "fit_s": fit_s}
    return flagship_entries("trained", counts, k1, k2), record


# ---- 58-63: the multi-axis nets' training (the static net: llff_z_plane,
# shiny_z_plane; the dynamic multi-axis net: neural_3d_z_plane)
# the static blob scene: 16 views of 128^2 rays (262,144 rays, 16 batches
# of DEFAULT_TRAINING's 16,384), marched on the card
STATIC_TRAIN_SCENE = {"n_views": 16, "wh": (128, 128), "dynamic": False}
STATIC_EVENTS = (20, 30)        # llff's first two upsamples; shiny's alpha
                                # event and first upsample (the presets:
                                # 4,000 and 6,000; 4,000 and 4,000)
N3D_TRAIN_STEPS = 20            # n3d's steps before its frame, no events
# the box shiny's net shrinks to if its alpha event left the aabb where it
# was (its z faces on no z-plane anchor of the 32)
SHINY_SHRUNK = [[-1.6, -1.7, -0.9], [1.7, 1.6, 0.9]]
MULTI_PRESETS = {"llff": "llff_z_plane", "shiny": "shiny_z_plane",
                 "n3d": "neural_3d_z_plane"}


def multi_training_setup(torch, dev, family, ds):
    """llff_z_plane, shiny_z_plane or neural_3d_z_plane at full width (the
    preset's grid: 2,097,152 voxels over its aabb, [8, 4, 4] components;
    the bf16 MLP policy and tables) with its grid events moved early
    (STATIC_EVENTS; n3d none), DEFAULT_TRAINING and tv_4000_defaults, the
    blob scene's bounds and depth range as its dataset_info (n3d with
    n3d_info()'s keyframes): (cfg, dataset_info, trainer)."""
    import copy

    from hyperreel_tpu_torch.config import DEFAULT_TRAINING
    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.trainer import Trainer

    cfg = presets.convert_epochs_to_iters(
        getattr(presets, MULTI_PRESETS[family])(), iters_per_epoch=4000)
    net = cfg["color"]["net"]
    first, second = STATIC_EVENTS
    if family == "llff":
        net["upsamp_list"] = [first, second] + net["upsamp_list"][2:]
    elif family == "shiny":
        net["update_AlphaMask_list"] = [first] \
            + net["update_AlphaMask_list"][1:]
        net["upsamp_list"] = [second] + net["upsamp_list"][1:]
    else:
        net["upsamp_list"], net["update_AlphaMask_list"] = [], []
    info = dict(ds.info(), **(n3d_info() if family == "n3d" else {}))
    model = build_model(copy.deepcopy(cfg), dataset_info=info,
                        compute_dtype=torch.bfloat16)
    trainer = Trainer(model, copy.deepcopy(DEFAULT_TRAINING),
                      regularizer_cfgs=tv_4000_defaults(),
                      iters_per_epoch=4000, device=dev)
    return cfg, info, trainer


def multi_fit(torch, dev, family, trainer, ds, steps, tag):
    """`steps` of Trainer.fit from the init of torch.Generator seed SEED,
    in two calls split between the two events: every loss and param
    finite, the mean image loss of the last 5 steps below the first 5's,
    grid_size as n_to_reso gives it after the upsamples, each optimizer
    counter restarted at each event. Returns (the initial state, the
    trained state, a record)."""
    import copy

    from hyperreel_tpu_torch.models.tensorf import n_to_reso

    net = trainer.model.color_net
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    state0 = copy.deepcopy(state)
    grid0, aabb0 = list(net.grid_size), net.aabb.copy()
    batches = ds.batch_iterator(trainer.training_cfg["batch_size"],
                                seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    events = sorted(set(trainer.alpha_list + trainer.upsamp_list)
                    & set(range(1, steps + 1)))
    split = (events[0] + events[1]) // 2 if len(events) > 1 else steps // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = trainer.fit(state, batches, split, gen=gen, log_every=1)
    counts_mid = dict(state.opt_state["count"])
    aabb_mid = net.aabb.copy()
    state, hist2 = trainer.fit(state, batches, steps - split, gen=gen,
                               log_every=1)
    hist += hist2
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = [h["image_loss"] for h in hist]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    ups = [i for i in trainer.upsamp_list if i <= steps]
    want_grid = n_to_reso(net.n_voxel_list[len(ups) - 1], net.aabb) \
        if ups else grid0
    print(f"# {tag}: {steps} steps in {fit_s:.2f} s: image loss first 5 "
          f"{first:.5f}, last 5 {last:.5f}; psnr {hist[0]['psnr']:.2f} -> "
          f"{hist[-1]['psnr']:.2f}; grid {grid0} -> {net.grid_size} (want "
          f"{want_grid}); aabb {aabb0.tolist()} -> {aabb_mid.tolist()} at "
          f"{split}; events {events}; optimizer counters {counts_mid} at "
          f"{split}, {state.opt_state['count']} at the end", flush=True)
    if not (all(np.isfinite(h[k]) for h in hist for k in h)
            and params_finite(torch, state.params)):
        raise AssertionError(f"{tag}: a loss or a param is not finite")
    if not last < first:
        raise AssertionError(f"{tag}: the image loss did not fall ({first} "
                             f"-> {last})")
    if net.grid_size != want_grid or state.it != steps:
        raise AssertionError(f"{tag}: grid {net.grid_size}, want "
                             f"{want_grid}; it {state.it}")
    groups = set(state.opt_state["count"])
    after = [split - e for e in events if e <= split]
    if events and (counts_mid != dict.fromkeys(
            groups, min(after) if after else split)
            or state.opt_state["count"] != dict.fromkeys(
                groups, steps - events[-1])):
        raise AssertionError(f"{tag}: the optimizer's counters did not "
                             "restart at the events")
    record = {"grid": [grid0, list(net.grid_size)],
              "aabb": [aabb0.tolist(), np.asarray(net.aabb).tolist()],
              "image_loss_first5_last5": [first, last], "fit_s": fit_s}
    return state0, state, record


def multi_step_times(torch, trainer, state0, state, aabb0, ds, tag):
    """The step's time (time_steps) on the initial grid (its aabb put back
    for the run) and, where the events changed it, on the trained grid."""
    net = trainer.model.color_net
    aabb_now, net.aabb = net.aabb, aabb0
    timing = {"initial": time_steps(torch, trainer, state0, ds,
                                    f"{tag} on the initial grid")}
    net.aabb = aabb_now
    if any(a.shape != b.shape for a, b in zip(
            state0.params["color"]["density"].values(),
            state.params["color"]["density"].values())):
        timing["trained"] = time_steps(
            torch, trainer, state, ds, f"{tag} on the trained grid "
            f"{list(net.grid_size)}")
    torch.cuda.empty_cache()
    return timing


def trained_multi_frame(torch, dev, family, cfg, info, model, state, frame,
                        reset_counts, read_counts, full=False, label=None,
                        gt=None):
    """A trained multi-axis model (its state at its last iteration): a
    frame (the bench frame's chunks, or a view's: `frame` is a tensor
    [chunks, rays, D] or a list of [rays, D]; the records are named by
    `label`, the family by default) through model.apply on the quad
    route (K1, K5; n3d's on
    its time planes) and, with `full`, the fused (K6) and two-kernel (K4
    + K5-preblended) patch routes at R=4 (4, 3): finite, in [0, 1], the
    launches per chunk, each patch route's witness <= PVIOL_EXACT; the
    fused route's rgb within PATH_TOL of the quad route's. The two-kernel
    route blends into bf16 features (K4, as the JAX package's), which on
    a trained model moves its rgb by ~1e-3 from the quad route's in both
    packages (PERF.md 6): its difference is printed, and on one
    chunk K4 + K5-preblended is held against K4's and K5-preblended's
    plain versions chained (PATH_TOL). On one chunk each kernel against
    its plain version (K1 PACK_TOL_BF16, the shade kernels SHADE_TOL on
    rgb/acc, K4 one bf16 ulp, the witness counts equal), timed, with its
    plain version's time and its bound; with `full`, fused against
    general under the f32 MLP policy on 4096 rays (PATH_TOL). With `gt`
    (the view's rgb), the quad route's frame is also timed and scored.
    Returns the kernels' JSON records and, with `gt`, {"view_ms",
    "view_psnr"} ({} without)."""
    import copy

    from hyperreel_tpu_torch.configs.presets import with_coherent_gather
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        pack_build, pack_build_plain)
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        patch_blend, patch_blend_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        MultiSpec, shade_multi, shade_multi_plain, shade_multi_preblended,
        shade_multi_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
        shade_multi_patch, shade_multi_patch_plain)
    from hyperreel_tpu_torch.train.metrics import psnr

    net = model.color_net

    def like(c, bf16=True):
        """A model of config `c` on the trained net's grid and aabb."""
        m = build_model(copy.deepcopy(c), dataset_info=info,
                        compute_dtype=torch.bfloat16 if bf16 else None)
        m.color_net.grid_size = list(net.grid_size)
        m.color_net.aabb = np.array(net.aabb)
        return m

    params = state.params
    ctx = StepCtx(it=state.it)
    label = label or family
    tag = f"trained {label}"
    frames = frame if family == "n3d" else [f[..., :6].contiguous()
                                            for f in frame]
    n_chunks = len(frames)
    n_rays = sum(f.shape[0] for f in frames)
    cf = model._cf_eval
    rgb_colour = net.shading == "rgb"
    with torch.no_grad():
        prep = model.prepare_eval(params)
        axes = prep["axes"]
        timed = any(a.TH for a in axes)
        routes = {"quad": ("0", model, frames, {"cf_prepared": prep},
                           {"shade_multi": n_chunks}, None)}
        R4 = PATCH_R4[2]
        if full:
            model4 = like(with_coherent_gather(cfg, *PATCH_R4))
            prep4 = model4.prepare_eval(params)
            frames4 = phase_major(torch.stack(list(frames)),
                                  R4).contiguous()
            rk4 = {"cf_prepared": prep4, "rays_phase_major": True}
            routes["fused patch R=4 (4,3)"] = (
                "1", model4, frames4, rk4, {"shade_multi_patch": n_chunks},
                R4)
            routes["two-kernel patch R=4 (4,3)"] = (
                "0", model4, frames4, rk4,
                {"patch_blend": n_chunks,
                 "shade_multi_preblended": n_chunks}, R4)
        counts, rgb_quad, view = {}, None, {}
        for name, (env, m, frs, rkw, kern, R) in routes.items():
            with EnvVar("HYPERREEL_FUSED_PATCH_MULTI", env):

                def render():
                    return [m.apply(params, frs[i], ctx, rkw)
                            for i in range(n_chunks)]

                reset_counts()
                outs = render()
                torch.cuda.synchronize()
                got = read_counts()
                if R is None and gt is not None:
                    view["view_ms"] = cuda_ms(torch, render, 3)
            want = dict.fromkeys(got, 0)
            want.update(pack_build=n_chunks, **kern)
            counts[name] = got
            rgb = torch.cat([scanline(o["rgb"], R) if R else o["rgb"]
                             for o in outs])
            if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                    and rgb.max() <= 1 and rgb.shape == (n_rays, 3)):
                raise AssertionError(f"{tag} {name}: frame rgb is not finite "
                                     "in [0, 1]")
            if got != want:
                raise AssertionError(f"{tag} {name}: kernel launches {got}, "
                                     f"want {want}")
            if R is None:
                rgb_quad = rgb
                if gt is not None:
                    view["view_psnr"] = psnr(rgb, gt).item()
                print(f"# {tag} frame ({name}): rgb min "
                      f"{rgb.min().item():.4f} max {rgb.max().item():.4f} "
                      f"mean {rgb.mean().item():.4f}; launches {got}"
                      + (f"; {view['view_ms']:.3f} ms per frame, psnr "
                         f"{view['view_psnr']:.3f} dB" if view else ""),
                      flush=True)
                continue
            pviol = max(float(o["patch_coverage_viol"]) for o in outs)
            err = (rgb - rgb_quad).abs().max().item()
            fused = env == "1"
            print(f"# {tag} frame ({name}, phase-major rays): launches "
                  f"{got}; coverage witness {pviol:.3e} (gate "
                  f"{PVIOL_EXACT}); rgb vs the quad route's frame {err:.3e} "
                  + (f"(tol {PATH_TOL})" if fused else
                     "(bf16 features; the chunk's chain is held below)"),
                  flush=True)
            if not (pviol <= PVIOL_EXACT and (err <= PATH_TOL or not fused)):
                raise AssertionError(f"{tag} {name}: witness {pviol}, rgb "
                                     f"error {err}")
        del outs, rgb, rgb_quad

        # one chunk: K1 and K5 (and K4, K5-pre, K6 on the R=4 phase-major
        # chunk) against their plain versions
        chunk = frames[0]
        net_in = cf.pred.net_input(chunk, ctx).float().contiguous()
        rp = cf.ray_pack(chunk)
        tabs = prep["mlp"]
        pack = pack_build(net_in, tabs, rp, cf.spec, ctx.it)
        pack_p = pack_build_plain(net_in, tabs, rp, cf.spec, ctx.it)
        torch.cuda.synchronize()
        errs = {"K1": (pack - pack_p).abs().max().item()}
        del pack_p
        spec = MultiSpec(S=cf.S, axes=axes, deg=net.sh_deg,
                         distance_scale=net.distance_scale,
                         shading=net.shading)
        lines, wb = prep["lines"], prep["wb"]
        out = shade_multi(prep["quads"], lines, pack, rp, wb, spec)
        out_p = shade_multi_plain(prep["quads"], lines, pack, rp, wb, spec)
        torch.cuda.synchronize()
        errs["K5"] = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derrs = {"K5": (out[:, 4] - out_p[:, 4]).abs().max().item()}
        kernels = {
            "K1": (lambda: pack_build(net_in, tabs, rp, cf.spec, ctx.it),
                   lambda: pack_build_plain(net_in, tabs, rp, cf.spec,
                                            ctx.it)),
            "K5": (lambda: shade_multi(prep["quads"], lines, pack, rp, wb,
                                       spec),
                   lambda: shade_multi_plain(prep["quads"], lines, pack, rp,
                                             wb, spec))}
        if full:
            chunk4 = frames4[0]
            rp4 = cf.ray_pack(chunk4)
            pack4 = pack_build(cf.pred.net_input(chunk4, ctx).float()
                               .contiguous(), tabs, rp4, cf.spec, ctx.it)
            pspecs = model4._cf_eval.patch_specs(
                [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], True)
            feats, viol_k4, errs["K4"] = k4_check(
                torch, tag, prep4["ptabs"], pack4, pspecs)
            pre = shade_multi_preblended(feats, lines, pack4, rp4, wb, spec)
            pre_p = shade_multi_preblended_plain(feats, lines, pack4, rp4,
                                                 wb, spec)
            k6, vk = shade_multi_patch(prep4["ptabs"], lines, pack4, rp4, wb,
                                       spec, pspecs)
            k6_p, vp = shade_multi_patch_plain(prep4["ptabs"], lines, pack4,
                                               rp4, wb, spec, pspecs)
            torch.cuda.synchronize()
            errs["K5-pre"] = (pre[:, :4] - pre_p[:, :4]).abs().max().item()
            derrs["K5-pre"] = (pre[:, 4] - pre_p[:, 4]).abs().max().item()
            errs["K6"] = (k6[:, :4] - k6_p[:, :4]).abs().max().item()
            derrs["K6"] = (k6[:, 4] - k6_p[:, 4]).abs().max().item()
            # the two-kernel chain against both plain versions chained
            chain_p = shade_multi_preblended_plain(
                patch_blend_plain(prep4["ptabs"], pack4, pspecs)[0], lines,
                pack4, rp4, wb, spec)
            chain_err = (pre[:, :4] - chain_p[:, :4]).abs().max().item()
            print(f"# {tag} chunk through K4 + K5-preblended vs both plain "
                  f"versions chained: {chain_err:.3e} (tol {PATH_TOL})",
                  flush=True)
            if not int(vk) == int(vp) == viol_k4 \
                    or not chain_err <= PATH_TOL:
                raise AssertionError(f"{tag}: witness counts K6 {int(vk)}, "
                                     f"plain {int(vp)}, K4 {viol_k4}; the "
                                     f"two-kernel chain {chain_err}")
            del chain_p
            kernels.update({
                "K4": (lambda: patch_blend(prep4["ptabs"], pack4, pspecs),
                       lambda: patch_blend_plain(prep4["ptabs"], pack4,
                                                 pspecs)),
                "K5-pre": (lambda: shade_multi_preblended(
                    feats, lines, pack4, rp4, wb, spec),
                    lambda: shade_multi_preblended_plain(
                        feats, lines, pack4, rp4, wb, spec)),
                "K6": (lambda: shade_multi_patch(prep4["ptabs"], lines,
                                                 pack4, rp4, wb, spec,
                                                 pspecs),
                       lambda: shade_multi_patch_plain(
                           prep4["ptabs"], lines, pack4, rp4, wb, spec,
                           pspecs))})
            del pre_p, k6_p
        del out_p
        print(f"# {tag} chunk: max |kernel - plain| " + ", ".join(
            f"{k} {e:.3e}" + (f" (depth {derrs[k]:.3e})" if k in derrs
                              else "") for k, e in errs.items())
            + f" (tol K1 {PACK_TOL_BF16}, shade {SHADE_TOL}, depth "
            f"{10 * SHADE_TOL}, K4 one bf16 ulp); acc mean "
            f"{out[:, 3].mean().item():.4f}; grid {list(net.grid_size)}, "
            f"aabb {np.asarray(net.aabb).tolist()}", flush=True)
        if not (errs["K1"] <= PACK_TOL_BF16
                and all(errs[k] <= SHADE_TOL and derrs[k] <= 10 * SHADE_TOL
                        for k in derrs)):
            raise AssertionError(f"{tag}: a kernel disagrees with its plain "
                                 f"version: {errs}, {derrs}")
        ms = {k: cuda_ms(torch, fn, 20) for k, (fn, _) in kernels.items()}
        plain_ms = {k: cuda_ms(torch, fn, 2) for k, (_, fn) in kernels.items()}

        # the bounds, as phases 10 and 15 count them
        N = pack.shape[1]
        valid = valid_count(pack)
        out_bytes = CHUNK * 5 * 4
        mlp_ops = 2 * CHUNK * sum(
            p["weight"].numel() for p in
            params["embedding"]["ray_prediction_0"]["net"].values())
        contract = K1_CONTRACT_OPS if cf.spec.contract.name != "identity" \
            else 0
        bounds = {
            "K1": bound(nbytes(net_in, rp, pack)
                        + sum(nbytes(l.w, l.b) for l in tabs.layers),
                        [(mlp_ops, BF16_OPS_PER_S),
                         (N * (k1_tail_ops(cf.S) + contract),
                          F32_OPS_PER_S)]),
            "K5": sh_bound(
                f"{tag} K5", nbytes(pack, *lines) + out_bytes
                + ray_bytes(rp, rgb_colour, timed) + sum(
                    rows_bytes(q, quad_rows(pack, a.m0, a.m1, a.W, a.H))
                    for q, a in zip(prep["quads"], axes)),
                lambda f: [(valid * multi_ops(axes, lambda C: 8 * C + 10,
                                              rgb_colour, fold=f)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)}
        if full:
            valid4 = valid_count(pack4)
            shared = (nbytes(pack4, *lines) + out_bytes
                      + ray_bytes(rp4, rgb_colour, timed))
            bounds["K4"] = bound(
                nbytes(pack4[:4], *feats) + 4 + sum(
                    rows_bytes(t, patch_rows(pack4, ps, True))
                    for t, ps in zip(prep4["ptabs"], pspecs)),
                [(N * sum(8 * a.C + 22 for a in axes), F32_OPS_PER_S)])
            bounds["K5-pre"] = sh_bound(
                f"{tag} K5-pre", shared + nbytes(*feats),
                lambda f: [(valid4 * multi_ops(axes, lambda C: C, rgb_colour,
                                               fold=f)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
            bounds["K6"] = sh_bound(
                f"{tag} K6", shared + 4 + sum(
                    rows_bytes(t, patch_rows(pack4, ps, False))
                    for t, ps in zip(prep4["ptabs"], pspecs)),
                lambda f: [(valid4 * multi_ops(axes, lambda C: 8 * C + 22,
                                               rgb_colour, fold=f)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
        print(f"# {tag} chunk: {valid} of {N} samples valid; " + "; ".join(
            f"{k} {ms[k]:.3f} ms (plain {plain_ms[k]:.3f}, bound "
            f"{bounds[k][0]:.4f} {bounds[k][1]})" for k in kernels),
            flush=True)
        del pack, out
        if full:
            del pack4, feats, pre, k6, prep4, model4
        torch.cuda.empty_cache()

        if full:
            # fused against the general path, f32 MLP policy, on the
            # params with the lines rounded to bf16 (the general net reads
            # them at table precision, K5 in f32), over the rays without a
            # sample within FACE_ULPS of an aabb face (as phase 56)
            cfg_g = copy.deepcopy(cfg)
            cfg_g["color"]["net"].update(fused_render_cf=False,
                                         fused_render=False)
            rays = torch.from_numpy(entry_rays(4096)[:, :6].copy()).to(dev)
            p16 = bf16_second_factors(torch, params)
            fused_m = like(cfg, bf16=False)
            a = fused_m.apply(p16, rays, ctx)["rgb"]
            b = like(cfg_g, bf16=False).apply(p16, rays, ctx)["rgb"]
            fcf = fused_m._cf_eval
            near = near_face(torch, pack_build(
                fcf.pred.net_input(rays, ctx).float().contiguous(),
                fcf.prepare(p16)["mlp"], fcf.ray_pack(rays), fcf.spec,
                ctx.it), fcf.S)
            path_err = (a - b).abs()[~near].max().item()
            print(f"# {tag}, fused vs general (f32 MLP), 4096 entry() rays: "
                  f"max |diff| {path_err:.3e} (tol {PATH_TOL}) over the rays "
                  f"without a sample within {FACE_ULPS} ulps of an aabb face "
                  f"({int(near.sum())} left out); with them "
                  f"{(a - b).abs().max().item():.3e}", flush=True)
            if not path_err <= PATH_TOL:
                raise AssertionError(f"{tag}: fused and general paths "
                                     f"disagree: {path_err}")

    src = "hyperreel_tpu/ops/pallas/"
    quad, two, fused = ("quad", "two-kernel patch R=4 (4,3)",
                        "fused patch R=4 (4,3)")
    rows = [("K1", f"pack_build_{label}_trained", "pack_build.cuh",
             "pack_build.py:137", quad, "pack_build"),
            ("K5", f"shade_multi_{label}_trained", "shade_multi.cu",
             "shade.py:742", quad, "shade_multi")]
    if full:
        rows += [("K4", f"patch_blend_{label}_trained", "patch_blend.cu",
                  "patch_blend.py:51", two, "patch_blend"),
                 ("K5-pre", f"shade_multi_preblended_{label}_trained",
                  "shade_multi.cu", "shade.py:761", two,
                  "shade_multi_preblended"),
                 ("K6", f"shade_multi_patch_{label}_trained",
                  "shade_multi_patch.cu", "shade.py:786", fused,
                  "shade_multi_patch")]
    return [entry(name, source, src + repl, counts[route][fn], errs[k],
                  ms[k], plain_ms[k], bounds[k])
            for k, name, source, repl, route, fn in rows], view


def multi_training_phases(torch, dev, card, frame, reset_counts,
                          read_counts):
    """Phases 58-63: train llff_z_plane across two upsamples, time its
    step, render the trained model through K1 + K5, K6 and K4 + K5-pre;
    train shiny_z_plane across an alpha event with its shrink and an
    upsample, time its step, render it through K1 + K5 (RGB); time
    neural_3d_z_plane's step and render it through K1 + K5 on its time
    planes; resume llff from a checkpoint. Returns (the kernels' JSON
    records, the training record)."""
    import copy

    from hyperreel_tpu_torch.data.synthetic import gaussian_blob_scene
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from hyperreel_tpu_torch.train.optim import tree_leaves
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.trainer import Trainer, TrainState

    t0 = time.perf_counter()
    ds = gaussian_blob_scene(**STATIC_TRAIN_SCENE, device=dev)
    print(f"# static blob scene: {ds.num_rays} rays ({ds.num_images} images "
          f"of {STATIC_TRAIN_SCENE['wh']}) marched in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    records, record = [], {}

    # ---- 58. llff_z_plane: 60 steps across two upsamples
    cfg, info, trainer = multi_training_setup(torch, dev, "llff", ds)
    state0, state, record["llff"] = multi_fit(
        torch, dev, "llff", trainer, ds, TRAIN_STEPS, "58. llff training")
    net = trainer.model.color_net
    # ---- 59. its step on the initial and the upsampled grid
    record["llff"]["step"] = multi_step_times(
        torch, trainer, state0, state, net.aabb.copy(), ds, "59. llff step")
    del state0
    # ---- 60. the trained model's bench frame on its three routes
    records += trained_multi_frame(torch, dev, "llff", cfg, info,
                                   trainer.model, state, frame,
                                   reset_counts, read_counts, full=True)[0]
    llff = (cfg, info, trainer, state)

    # ---- 61. shiny_z_plane (RGB): 60 steps across the alpha event (its
    # shrink) and an upsample; its step; its bench frame on the quad route
    cfg, info, trainer = multi_training_setup(torch, dev, "shiny", ds)
    net = trainer.model.color_net
    aabb0 = net.aabb.copy()
    state0, state, record["shiny"] = multi_fit(
        torch, dev, "shiny", trainer, ds, TRAIN_STEPS, "61. shiny training")
    moved = not np.array_equal(net.aabb, aabb0)
    shapes = {k: tuple(v.shape) for k, v in
              state.params["color"]["density"].items()}
    if not moved:
        # the shrink by hand (the net crops its planes and lines), so that
        # the frame renders on another aabb and cropped grids either way
        params = dict(state.params, color=net.shrink(
            state.params["color"], np.asarray(SHINY_SHRUNK)))
        state = TrainState(params, trainer.make_optimizer(params).init(
            params), state.it)
        print(f"# shiny: the alpha event left the aabb; the net shrunk to "
              f"{SHINY_SHRUNK} by hand: grid {net.grid_size}", flush=True)
    cropped = {k: tuple(v.shape) for k, v in
               state.params["color"]["density"].items()}
    if np.array_equal(net.aabb, aabb0) or (not moved and cropped == shapes):
        raise AssertionError("shiny: the shrink moved no face of the aabb "
                             "or cropped no grid")
    record["shiny"]["shrink_by_event"] = moved
    record["shiny"]["step"] = multi_step_times(
        torch, trainer, state0, state, aabb0, ds, "61. shiny step")
    del state0
    records += trained_multi_frame(torch, dev, "shiny", cfg, info,
                                   trainer.model, state, frame,
                                   reset_counts, read_counts)[0]
    del trainer, state
    torch.cuda.empty_cache()

    # ---- 62. neural_3d_z_plane: N3D_TRAIN_STEPS steps (no events), its
    # step, its bench frame through K1 + K5 on the time planes
    t0 = time.perf_counter()
    dds = gaussian_blob_scene(**TRAIN_SCENE, device=dev)
    print(f"# dynamic blob scene marched in {time.perf_counter() - t0:.2f} "
          "s", flush=True)
    cfg, info, trainer = multi_training_setup(torch, dev, "n3d", dds)
    _, state, record["n3d"] = multi_fit(
        torch, dev, "n3d", trainer, dds, N3D_TRAIN_STEPS, "62. n3d training")
    record["n3d"]["step"] = {"trained": time_steps(
        torch, trainer, state, dds, "62. n3d step (64 samples, time planes "
        "of 12 keyframes)")}
    records += trained_multi_frame(torch, dev, "n3d", cfg, info,
                                   trainer.model, state, frame,
                                   reset_counts, read_counts)[0]
    del trainer, state, dds
    torch.cuda.empty_cache()

    # ---- 63. llff: save, restore into a fresh model and trainer, one step
    # on both under torch's deterministic algorithms: equal to the bit
    cfg, info, trainer, state = llff
    ckpt = os.path.join("build", "chip_smoke_ckpt_llff")
    save_checkpoint(ckpt, state, trainer.model)
    fresh = build_model(copy.deepcopy(cfg), dataset_info=info,
                        compute_dtype=torch.bfloat16)
    trainer2 = Trainer(fresh, trainer.training_cfg,
                       regularizer_cfgs=tv_4000_defaults(),
                       iters_per_epoch=4000, device=dev)
    state2 = restore_checkpoint(ckpt, trainer2)
    net, net2 = trainer.model.color_net, fresh.color_net
    if net2.grid_size != net.grid_size or not np.array_equal(
            net2.aabb, net.aabb) or state2.it != state.it:
        raise AssertionError("llff restore: grid, aabb or iteration differ")
    batch = next(ds.batch_iterator(trainer.training_cfg["batch_size"],
                                   seed=SEED + 11))
    draws = {"background": 0.25}
    torch.use_deterministic_algorithms(True)
    try:
        state, m1 = trainer.step(state, trainer.to_device(batch),
                                 trainer.make_optimizer(state.params),
                                 draws=draws)
        state2, m2 = trainer2.step(state2, trainer2.to_device(batch),
                                   trainer2.make_optimizer(state2.params),
                                   draws=draws)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    p2 = dict(tree_leaves(state2.params))
    resume_ok = all(torch.equal(p2[p], v)
                    for p, v in tree_leaves(state.params))
    print(f"# 63. llff resumed step: loss {m2['loss'].item():.9g} vs "
          f"{m1['loss'].item():.9g}; params equal to the bit: {resume_ok}; "
          f"counters {state2.opt_state['count']}", flush=True)
    if not (m1["loss"].item() == m2["loss"].item() and resume_ok
            and state2.opt_state["count"] == state.opt_state["count"]):
        raise AssertionError("the resumed llff step differs from the "
                             "uninterrupted one")
    return records, record


# ---- 64-66: training from scenes on disk (the port's loaders and ray
# store). The scenes are written by this script, from SEED, into a
# temporary directory: PNG by a stdlib writer, smooth fields that differ
# per camera and frame.
TECH_WH = (2048, 1088)          # the published rig's resolution
TECH_RIG = 4                    # the published 4 x 4 rig
TECH_FRAMES = 9                 # of the published 50-frame window
# the train rays: 15 cameras x 2,228,224 pixels x (2 whole frames + 1 at
# 1/4 + 6 at 1/8)
TECH_TRAIN_RAYS = 100_270_080
TECH_VAL_FRAME = 4
# what 9 frames need: the rays in memory while the store is written
# (~10 GB with the loader's copies) and the store on disk (48 bytes a ray)
TECH_RAM_BYTES = 16 << 30
TECH_DISK_BYTES = 7 << 30
LLFF_CAPTURE = (4032, 3024)     # the capture's size in poses_bounds.npy
LLFF_WH = (1008, 756)           # its published downsample=4 rays
LLFF_VIEWS = 20
LLFF_TRAIN_RAYS = 12_954_816    # 17 views (val_skip 8 holds out 0, 8, 16)
LLFF_VAL_VIEW = 8
DATA_STEPS = 60
STORE_GATHER = 4096
# the CLI runs (phases 67-73): epochs of CLI_ITERS steps, the flagship's
# alpha event and first upsample (the preset: 4000) moved into the run
CLI_ITERS = 200
CLI_EPOCHS = 2
CLI_ALPHA_IT = 100
CLI_UPSAMPLE_IT = 250
CLI_LLFF_ITERS = 100
CLI_LOG_EVERY = 50
VIEWER_SIDES = (512, 1024)
VIEWER_FRAMES = 5               # frames timed per ladder level
SERVE_FRAMES = ((0.0, 0.0), (0.2, -0.1), (-0.3, 0.15))   # (yaw, pitch)


def write_png(path, img):
    """uint8 [H, W, 3] as an 8-bit RGB PNG: zlib, filter 0 on every row."""
    import struct
    import zlib

    H, W, _ = img.shape
    raw = np.zeros((H, 1 + 3 * W), np.uint8)
    raw[:, 1:] = img.reshape(H, 3 * W)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


def smooth_image(wh, freqs, shift):
    """A smooth uint8 [H, W, 3] field: per channel a sinusoid across x plus
    one across y, `freqs` [3, 2] cycles per image, moved by `shift` (x, y)
    of a cycle (a camera's parallax, a frame's motion)."""
    W, H = wh
    x = np.arange(W, dtype=np.float32) / W
    y = np.arange(H, dtype=np.float32) / H
    out = np.empty((H, W, 3), np.uint8)
    for c, (fx, fy) in enumerate(freqs):
        v = (0.5 + 0.22 * np.sin(2 * np.pi * (fx * x + shift[0]))[None]
             + 0.22 * np.cos(2 * np.pi * (fy * y + shift[1]))[:, None])
        out[..., c] = np.clip(v * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return out


def write_images(jobs):
    """Write (path, wh, freqs, shift) images, eight threads at a time
    (zlib releases the interpreter's lock); every future is read."""
    from concurrent.futures import ThreadPoolExecutor

    def one(job):
        path, wh, freqs, shift = job
        write_png(path, smooth_image(wh, freqs, shift))

    with ThreadPoolExecutor(8) as ex:
        for fut in [ex.submit(one, j) for j in jobs]:
            fut.result()


def write_technicolor_scene(root, frames):
    """A Technicolor scene ("painter") at the published rig and
    resolution: a 4 x 4 rig of cameras 0.1 apart facing -z (unit
    quaternions within ~0.6 degrees of the identity, focal ~1,800 px at
    2048 x 1088), `frames` frames of smooth images."""
    rng = np.random.default_rng(SEED)
    d = os.path.join(root, "painter")
    os.makedirs(os.path.join(d, "images"))
    lines = ["focal cx cy aspect skew qw qx qy qz d1 d2 tx ty tz\n"]
    n = TECH_RIG * TECH_RIG
    for c in range(n):
        q = np.array([1.0, *rng.normal(0, 0.005, 3)])
        q /= np.linalg.norm(q)
        t = [0.1 * (c % TECH_RIG - 1.5), 0.1 * (c // TECH_RIG - 1.5),
             rng.normal(0, 0.005)]
        lines.append(" ".join(repr(float(v)) for v in [
            1800.0 + rng.normal(0, 5), 1024.0, 544.0, 1.0, 0.0, *q,
            0.0, 0.0, *t]) + "\n")
    with open(os.path.join(d, "cameras_parameters.txt"), "w") as f:
        f.writelines(lines)
    freqs = rng.uniform(0.5, 3.0, (3, 2))
    write_images([
        (os.path.join(d, "images", f"frame_{fi:04d}_cam_{c:02d}.png"),
         TECH_WH, freqs, (0.3 * (c % TECH_RIG) + 0.05 * fi,
                          0.3 * (c // TECH_RIG)))
        for fi in range(frames) for c in range(n)])
    return d


def write_llff_scene(root):
    """An LLFF scene of LLFF_VIEWS forward-facing views: poses_bounds.npy
    in LLFF's layout (rotation columns down, right, back; H, W and focal of
    a 4032 x 3024 capture; near ~1.2, far ~20), the images at 1008 x 756,
    the size of the published downsample=4 rays."""
    rng = np.random.default_rng(SEED + 1)
    d = os.path.join(root, "fern")
    os.makedirs(os.path.join(d, "images"))
    W0, H0 = LLFF_CAPTURE
    rows = np.zeros((LLFF_VIEWS, 17))
    for i in range(LLFF_VIEWS):
        R = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        R = R + rng.normal(0, 0.01, (3, 3))
        t = [0.05 * (i % 5 - 2), 0.05 * (i // 5 - 1.5), rng.normal(0, 0.01)]
        pose = np.concatenate([R, np.array(t)[:, None],
                               np.array([H0, W0, 3260.0])[:, None]], 1)
        rows[i, :15] = pose.reshape(-1)
        rows[i, 15:] = [1.2 + rng.uniform(0, 0.2), 20.0 + rng.uniform(0, 2)]
    np.save(os.path.join(d, "poses_bounds.npy"), rows)
    freqs = rng.uniform(0.5, 3.0, (3, 2))
    write_images([(os.path.join(d, "images", f"view_{i:03d}.png"), LLFF_WH,
                   freqs, (0.3 * (i % 5), 0.3 * (i // 5)))
                  for i in range(LLFF_VIEWS)])
    return d


class RssPeak:
    """The peak resident set of this process while the block runs, from
    /proc/self/status sampled every 20 ms by a thread (bytes)."""

    def __enter__(self):
        import threading

        self.peak, self._stop = self.now(), threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def now():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self.now())


def host_meminfo():
    """{field: bytes} of /proc/meminfo (MemTotal, MemAvailable, ...)."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            out[k] = int(v.split()[0]) * 1024
    return out


def host_report():
    """The early line: Pillow and cv2 (importable or not), the host's RAM,
    the free disk under the temporary directory."""
    import importlib.util
    import shutil
    import tempfile

    mem = host_meminfo()
    tmp = tempfile.gettempdir()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "cv2")}
    return (f"# host: PIL {have['PIL']}, cv2 {have['cv2']}; RAM "
            f"{mem['MemTotal'] / 2**30:.1f} GiB, available "
            f"{mem['MemAvailable'] / 2**30:.1f} GiB; free disk under {tmp} "
            f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB; "
            f"{os.cpu_count()} CPUs")


def host_ms(fn, reps):
    """Mean host milliseconds per call of fn over `reps` calls after one
    warm-up call (the sampler runs on the host)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def scene_trainer(torch, dev, preset, info):
    """The preset at full width (bf16 MLP policy and tables) with the
    loader's dataset_info, DEFAULT_TRAINING and tv_4000_defaults, its own
    events (none within DATA_STEPS): (cfg, trainer)."""
    import copy

    from hyperreel_tpu_torch.config import DEFAULT_TRAINING
    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.trainer import Trainer

    cfg = presets.convert_epochs_to_iters(getattr(presets, preset)(),
                                          iters_per_epoch=4000)
    model = build_model(copy.deepcopy(cfg), dataset_info=info,
                        compute_dtype=torch.bfloat16)
    trainer = Trainer(model, copy.deepcopy(DEFAULT_TRAINING),
                      regularizer_cfgs=tv_4000_defaults(),
                      iters_per_epoch=4000, device=dev)
    return cfg, trainer


def scene_fit(torch, dev, trainer, batches, tag):
    """DATA_STEPS of Trainer.fit from the init of torch.Generator seed
    SEED: every loss and param finite, the mean image loss of the last 5
    steps below the first 5's. Returns (state, record)."""
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = trainer.fit(state, batches, DATA_STEPS, gen=gen,
                              log_every=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = [h["image_loss"] for h in hist]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"# {tag}: {DATA_STEPS} steps in {fit_s:.2f} s "
          f"({fit_s * 1e3 / DATA_STEPS:.2f} ms a step, the sampler "
          f"included): image loss first 5 {first:.5f}, last 5 {last:.5f}; "
          f"psnr {hist[0]['psnr']:.2f} -> {hist[-1]['psnr']:.2f}",
          flush=True)
    if not (all(np.isfinite(h[k]) for h in hist for k in h)
            and params_finite(torch, state.params)):
        raise AssertionError(f"{tag}: a loss or a param is not finite")
    if not last < first:
        raise AssertionError(f"{tag}: the image loss did not fall ({first} "
                             f"-> {last})")
    return state, {"image_loss_first5_last5": [first, last], "fit_s": fit_s}


def step_ms(torch, trainer, state, batches, reps=20):
    """ms per training step (CUDA events over `reps` steps after one
    warm-up) on batches already on the card, on a copy of `state`."""
    import copy

    state = copy.deepcopy(state)
    opt = trainer.make_optimizer(state.params)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED)
    state, _ = trainer.step(state, batches[0], opt, gen)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for b in batches[1:reps + 1]:
        state, _ = trainer.step(state, b, opt, gen)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def view_chunks(torch, dev, view):
    """A whole view's rays as chunks of at most CHUNK on the card, and its
    image [N, 3]."""
    rays = torch.from_numpy(view["rays"]).to(dev)
    return (list(torch.split(rays, CHUNK)),
            torch.from_numpy(view["rgb"]).to(dev))


def data_phases(torch, dev, card, reset_counts, read_counts, tmp):
    """Phases 64-66: the flagship trained from a Technicolor scene at the
    published rig and resolution through the port's loader and ray store,
    its held-out view rendered through K1 + K2; llff_z_plane trained from
    an LLFF scene at its published setting, its held-out view rendered
    through K1 + K5; the ray store alone. The scenes are written under
    `tmp` and stay there (the CLI phases read them); the store's file is
    removed. Returns (the kernels' JSON records, the data record, the
    Technicolor scene's root, the LLFF scene's root)."""
    import shutil

    from hyperreel_tpu_torch.config import DEFAULT_TRAINING
    from hyperreel_tpu_torch.data import get_dataset
    from hyperreel_tpu_torch.data.raystore import MmapRayStore
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.train.metrics import psnr

    records, record = [], {}
    B = DEFAULT_TRAINING["batch_size"]

    # ---- 64. technicolor at the published rig and resolution
    mem, free = host_meminfo()["MemAvailable"], shutil.disk_usage(
        tmp).free
    frames = TECH_FRAMES
    if mem < TECH_RAM_BYTES or free < TECH_DISK_BYTES:
        raise RuntimeError(f"64. the host has {mem / 2**30:.1f} GiB "
                           f"available (needs "
                           f"{TECH_RAM_BYTES / 2**30:.0f}) and "
                           f"{free / 2**30:.1f} GiB of disk (needs "
                           f"{TECH_DISK_BYTES / 2**30:.0f}) for the "
                           f"{frames}-frame scene")
    print(f"# 64. the cut: {frames} frames of the published 50-frame "
          f"window (keyframe_step 4: "
          f"{frames // 4} keyframes, not 12); every width as published "
          f"(a {TECH_RIG} x {TECH_RIG} rig at {TECH_WH[0]} x "
          f"{TECH_WH[1]})", flush=True)
    t0 = time.perf_counter()
    root = tech_root = write_technicolor_scene(tmp, frames)
    write_s = time.perf_counter() - t0
    kw = dict(img_wh=TECH_WH, num_frames=frames, keyframe_step=4,
              load_full_step=8)
    with RssPeak() as rss:
        base_rss = rss.peak
        t0 = time.perf_counter()
        ds = get_dataset("technicolor", root, split="train", **kw)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        val = get_dataset("technicolor", root, split="val", **kw)
        val_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store_path = os.path.join(tmp, "train.npy")
        store = MmapRayStore.create(store_path, ds)
        store_s = time.perf_counter() - t0
    n_img = ds.num_images + val.num_images
    pixels = TECH_WH[0] * TECH_WH[1]
    print(f"# 64. scene of {frames * TECH_RIG ** 2} images written in "
          f"{write_s:.1f} s; loaded {ds.num_images} train images in "
          f"{train_s:.1f} s and {val.num_images} val in {val_s:.1f} s: "
          f"{(train_s + val_s) / n_img:.3f} s per {TECH_WH[0]} x "
          f"{TECH_WH[1]} image; {ds.num_rays} train rays, "
          f"{val.num_rays} val; dataset_info {ds.info()}; the ray "
          f"store {store.data.nbytes / 1e9:.2f} GB written in "
          f"{store_s:.1f} s ({store.n_threads} sampler threads); peak "
          f"RSS {rss.peak / 2**30:.2f} GiB (from {base_rss / 2**30:.2f} "
          f"before the load)", flush=True)
    if ds.num_rays != TECH_TRAIN_RAYS or \
            val.num_rays != frames * pixels:
        raise AssertionError(f"technicolor: {ds.num_rays} train rays, "
                             f"want {TECH_TRAIN_RAYS}; "
                             f"{val.num_rays} val, want "
                             f"{frames * pixels}")
    record["technicolor"] = {
        "frames": frames, "train_rays": ds.num_rays,
        "s_per_image": (train_s + val_s) / n_img, "write_s": write_s,
        "store_s": store_s, "peak_rss_bytes": rss.peak,
        "rss_before_bytes": base_rss}

    cfg, trainer = scene_trainer(torch, dev, "technicolor_z_plane",
                                 ds.info())
    state, record["technicolor"]["fit"] = scene_fit(
        torch, dev, trainer, store.batch_iterator(B, seed=SEED),
        "64. technicolor_z_plane from the ray store")

    # the sampler against the in-memory sampler and the step
    seeds = iter(range(10 ** 6, 2 * 10 ** 6))
    mem16 = ds.batch_iterator(B, seed=SEED + 1)
    mem262 = ds.batch_iterator(CHUNK, seed=SEED + 2)
    sampler = {
        "store_16384_ms": host_ms(lambda: store.sample(B, next(seeds)),
                                  20),
        "store_262144_ms": host_ms(
            lambda: store.sample(CHUNK, next(seeds)), 5),
        "memory_16384_ms": host_ms(lambda: next(mem16), 20),
        "memory_262144_ms": host_ms(lambda: next(mem262), 5)}
    sampler["step_ms"] = step_ms(torch, trainer, state, [
        trainer.to_device(store.sample(B, 2 * 10 ** 6 + i))
        for i in range(21)])
    print(f"# 64. {card}: the ray store's sampler "
          f"{sampler['store_16384_ms']:.3f} ms per batch of {B} rays, "
          f"{sampler['store_262144_ms']:.3f} ms per {CHUNK}; the "
          f"in-memory batch_iterator {sampler['memory_16384_ms']:.3f} "
          f"and {sampler['memory_262144_ms']:.3f} ms; the step "
          f"{sampler['step_ms']:.3f} ms (CUDA events, batches on the "
          "card)", flush=True)
    record["technicolor"]["sampler"] = sampler

    # the held-out camera's frame through K1 + K2
    model = trainer.model
    ctx = StepCtx(it=state.it)
    chunks, gt = view_chunks(torch, dev, val.image(TECH_VAL_FRAME))
    with torch.no_grad():
        prep = model.prepare_eval(state.params)
        rk = {"cf_prepared": prep, "uniform_time": True}

        def render():
            return [model.apply(state.params, c, ctx, rk)["rgb"]
                    for c in chunks]

        reset_counts()
        rgb = torch.cat(render())
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        want.update(pack_build=len(chunks), shade=len(chunks))
        frame_ms = cuda_ms(torch, render, 3)
        p = psnr(rgb, gt).item()
        print(f"# 64. {card}: the held-out camera (2, 2), frame "
              f"{TECH_VAL_FRAME} ({rgb.shape[0]} rays, {len(chunks)} "
              f"chunks, quad route): {frame_ms:.3f} ms per frame, psnr "
              f"{p:.3f} dB; rgb min {rgb.min().item():.4f} max "
              f"{rgb.max().item():.4f}; launches {counts}", flush=True)
        if counts != want:
            raise AssertionError(f"technicolor view: launches {counts}, "
                                 f"want {want}")
        if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                and rgb.max() <= 1 and rgb.shape == gt.shape):
            raise AssertionError("technicolor view: rgb not finite in "
                                 "[0, 1]")
        record["technicolor"].update(view_ms=frame_ms, view_psnr=p)
        k1, k2 = trained_flagship_chunk(torch, model, state.params,
                                        chunks[0], ctx, prep,
                                        "technicolor scene")
    records += flagship_entries("technicolor_scene_trained", counts, k1,
                                k2)
    tech = ds
    del trainer, model, state, prep, chunks, gt, rgb, val, ds
    torch.cuda.empty_cache()

    # ---- 65. llff at its published setting
    t0 = time.perf_counter()
    root = llff_root = write_llff_scene(tmp)
    write_s = time.perf_counter() - t0
    kw = dict(downsample=1, use_ndc=True, val_skip=8)
    t0 = time.perf_counter()
    ds = get_dataset("llff", root, split="train", **kw)
    val = get_dataset("llff", root, split="val", **kw)
    load_s = time.perf_counter() - t0
    print(f"# 65. llff: {LLFF_VIEWS} views written in {write_s:.1f} s, "
          f"loaded in {load_s:.1f} s ({load_s / LLFF_VIEWS:.3f} s per "
          f"{LLFF_WH[0]} x {LLFF_WH[1]} image); {ds.num_rays} train "
          f"rays of {ds.num_images} views; dataset_info {ds.info()}",
          flush=True)
    if ds.num_rays != LLFF_TRAIN_RAYS or tuple(ds.img_wh) != LLFF_WH:
        raise AssertionError(f"llff: {ds.num_rays} train rays at "
                             f"{ds.img_wh}, want {LLFF_TRAIN_RAYS} at "
                             f"{LLFF_WH}")
    cfg, trainer = scene_trainer(torch, dev, "llff_z_plane", ds.info())
    state, record["llff"] = scene_fit(
        torch, dev, trainer, ds.batch_iterator(B, seed=SEED),
        "65. llff_z_plane from the in-memory rays")
    record["llff"].update(s_per_image=load_s / LLFF_VIEWS,
                          train_rays=ds.num_rays)
    # view 8 is the second of the val split (0, 8, 16)
    chunks, gt = view_chunks(torch, dev, val.image(1))
    recs, view = trained_multi_frame(
        torch, dev, "llff", cfg, ds.info(), trainer.model, state, chunks,
        reset_counts, read_counts, label="llff_scene", gt=gt)
    records += recs
    print(f"# 65. {card}: the held-out view {LLFF_VAL_VIEW} "
          f"({gt.shape[0]} rays, {len(chunks)} chunks, quad route): "
          f"{view['view_ms']:.3f} ms per frame, psnr "
          f"{view['view_psnr']:.3f} dB", flush=True)
    record["llff"].update(view)
    del trainer, state, chunks, gt, ds, val
    torch.cuda.empty_cache()

    # ---- 66. the ray store alone, on 64's rays: gather against the
    # in-memory rows; a seed's batch twice, another seed's
    idx = np.random.default_rng(SEED).integers(0, store.num_rays,
                                               STORE_GATHER)
    got = store.gather(idx)
    gather_ok = all(np.array_equal(got[k], v[idx]) for k, v in (
        ("rays", tech.all_coords), ("rgb", tech.all_rgb),
        ("weights", tech.all_weights)))
    a, b, c = (store.sample(B, s)["rays"] for s in (SEED, SEED,
                                                     SEED + 1))
    print(f"# 66. the ray store ({store.num_rays} rows, "
          f"{store.n_threads} threads): gather of {STORE_GATHER} seeded "
          f"indices equal to the in-memory rows: {gather_ok}; one seed "
          f"twice equal: {np.array_equal(a, b)}; another seed differs: "
          f"{not np.array_equal(a, c)}", flush=True)
    if not (gather_ok and np.array_equal(a, b)
            and not np.array_equal(a, c)):
        raise AssertionError("the ray store's gather or sampler "
                             "disagrees")
    del store
    os.remove(store_path)
    return records, record, tech_root, llff_root



def png_size(data):
    """(W, H) of a PNG's bytes (its IHDR)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    return (int.from_bytes(data[16:20], "big"),
            int.from_bytes(data[20:24], "big"))


def fresh_host(tag):
    """Collect the garbage of the last System (its Trainer refers back to
    it) and refuse to go on with less than TECH_RAM_BYTES of the host's
    memory available; print the process's RSS and what is available."""
    import gc

    gc.collect()
    avail = host_meminfo()["MemAvailable"]
    print(f"# {tag}: RSS {RssPeak.now() / 2**30:.2f} GiB, available "
          f"{avail / 2**30:.1f} GiB", flush=True)
    if avail < TECH_RAM_BYTES:
        raise RuntimeError(f"{tag}: {avail / 2**30:.1f} GiB available, "
                           f"needs {TECH_RAM_BYTES / 2**30:.0f}")


def only(counts, **want):
    """`counts` with every kernel at 0 but those of `want`, which must be
    launched (a positive count, or the count given)."""
    for name, n in counts.items():
        w = want.get(name, 0)
        if (w is None and n <= 0) or (w is not None and n != w):
            return False
    return True


def viewer_ladder(torch, dev, card, reset_counts, read_counts, state, tag,
                  side, model, params, patch_model=None):
    """One InteractiveRenderer at base side^2 on the trained state: every
    ladder level warmed up, then VIEWER_FRAMES frames per level at the
    orbit camera's pose (device ms by CUDA events from before submit to
    after it, wall ms from submit to read) and the launches of one frame.
    Returns (the renderer, [per-level record])."""
    from hyperreel_tpu_torch.viewer import InteractiveRenderer, OrbitCamera

    pose = OrbitCamera(side, side).pose
    r = InteractiveRenderer(model=model, params=params, base_wh=(side, side),
                            ray_width=8, it=state.it,
                            patch_model=patch_model, device=dev)
    r.precompile()
    rows = []
    for level in range(len(r.ladder)):
        W, H = r._wh_for(level)
        dev_ms, wall_ms = [], []
        for i in range(VIEWER_FRAMES + 1):       # a warm-up, then timed
            r._level = level
            reset_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            handle = r.submit_frame(pose, t=0.5)
            end.record()
            img, dt = r.read_frame(handle)
            launches = {k: v for k, v in read_counts().items() if v}
            if i:
                dev_ms.append(start.elapsed_time(end))
                wall_ms.append(dt * 1e3)
        if img.shape != (H, W, 3) or img.dtype != np.uint8:
            raise AssertionError(f"viewer {tag}: frame {img.shape}")
        rows.append({"level": level, "wh": [W, H],
                     "device_ms": float(np.mean(dev_ms)),
                     "wall_ms": float(np.mean(wall_ms)),
                     "patch": bool(r.last_used_patch),
                     "launches": launches})
    print(f"# 71. {card}: viewer {tag} at base {side}^2 (CUDA events "
          f"submit span / wall submit-to-read, ms per frame; launches of "
          "one frame): " + "; ".join(
              f"level {x['level']} {x['wh'][0]}x{x['wh'][1]}"
              f"{' patch' if x['patch'] else ''} {x['device_ms']:.3f} / "
              f"{x['wall_ms']:.3f} {x['launches']}" for x in rows),
          flush=True)
    return r, rows



def cli_phases(torch, dev, card, reset_counts, read_counts, tmp, tech_root,
               llff_root):
    """Phases 67-73: the port's entry points as a user drives them. The
    flagship trained, evaluated, rendered along a spiral and exported as a
    mesh through hyperreel_tpu_torch.main.main (in this process), the
    viewer's ladder and its HTTP server on it; llff_z_plane trained and
    evaluated through the CLI with its visualizers. Returns (the kernels'
    JSON records, the CLI record)."""
    import itertools
    import shutil
    import threading
    import urllib.request

    import yaml

    from hyperreel_tpu_torch import main as cli
    from hyperreel_tpu_torch.config import DEFAULT_TRAINING, resolve_model_cfg
    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.train.metrics import psnr
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.render import Renderer
    from hyperreel_tpu_torch.viewer import (
        InteractiveRenderer, OrbitCamera, make_server)

    records, record = [], {}
    runs = os.path.join(tmp, "runs")
    B = DEFAULT_TRAINING["batch_size"]
    free = shutil.disk_usage(tmp).free
    if free < TECH_DISK_BYTES:
        raise RuntimeError(f"67. {free / 2**30:.1f} GiB of disk, the ray "
                           f"store needs {TECH_DISK_BYTES / 2**30:.0f}")

    # ---- 67. the flagship trained through the CLI
    cfg_path = os.path.join(tmp, "flagship.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "params": {"seed": SEED, "save_dir": runs, "name": "flagship",
                       "compute_dtype": "bfloat16"},
            "dataset": {"name": "technicolor", "root_dir": tech_root,
                        "img_wh": list(TECH_WH), "num_frames": TECH_FRAMES,
                        "keyframe_step": 4, "load_full_step": 8,
                        "use_raystore": True},
            "model": "technicolor_z_plane",
            "training": {"num_iters": CLI_ITERS, "num_epochs": CLI_EPOCHS,
                         "val_every": 1, "log_every": CLI_LOG_EVERY},
            "regularizers": tv_4000_defaults()}, f)
    later = presets.technicolor_z_plane()["color"]["net"]["upsamp_list"][1:]
    # the intersect sorts invalid samples far, so that the viewer's fast
    # mode can compact (the first k sorted samples)
    argv = ["--config", cfg_path, "--device", str(dev),
            f"model.color.net.update_AlphaMask_list=[{CLI_ALPHA_IT}]",
            "model.color.net.upsamp_list="
            + json.dumps([CLI_UPSAMPLE_IT] + later),
            "model.embedding.embeddings.ray_intersect_0.intersect."
            "invalid_sort_far=true"]
    fresh_host("67")
    reset_counts()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        system, state, done = cli.main(argv)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    counts = read_counts()
    run = os.path.join(runs, "flagship")
    with open(os.path.join(run, "metrics.txt")) as f:
        vals = [json.loads(line) for line in f]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    with open(os.path.join(run, "last", "meta.json")) as f:
        meta = json.load(f)
    steps = CLI_ITERS * CLI_EPOCHS
    fit_s = done["fit"]
    step = step_ms(torch, system.trainer, state, [
        system.trainer.to_device(b) for b in itertools.islice(
            system.train_dataset.batch_iterator(B, seed=SEED + 3), 21)])
    net = system.model.color_net
    # K1 and K2 once per chunk of each image the run rendered: two at each
    # validation, then every held-out image at the end (main's "final")
    W, H = system.val_dataset.img_wh
    per_image = -(-W * H // CHUNK)
    n_img = 2 * CLI_EPOCHS + system.val_dataset.num_images
    print(f"# 67. {card}: the CLI trained technicolor_z_plane {steps} steps "
          f"(alpha event {CLI_ALPHA_IT}, upsample {CLI_UPSAMPLE_IT}) from the "
          f"ray store in {fit_s:.1f} s of fit ({call_s:.1f} s with the "
          f"load, the store and the final validation; peak RSS "
          f"{rss.peak / 2**30:.2f} GiB); held-out PSNR "
          + ", ".join(f"it {v['it']} {v['psnr']:.3f} dB (ssim "
                      f"{v['ssim']:.4f})" for v in vals)
          + f"; logged loss {logged[0]['loss']:.5f} -> "
          f"{logged[-1]['loss']:.5f} over {len(logged)} metrics.jsonl "
          f"lines; the step {step:.3f} ms (CUDA events, 20 steps on "
          f"batches on the card); last checkpoint it {meta['it']}, grid "
          f"{meta['grid_size']}, aabb {meta['aabb']}; the validations' "
          f"launches {counts}", flush=True)
    if not (state.it == steps == meta["it"]
            and [v["it"] for v in vals] == list(range(
                CLI_ITERS, steps + 1, CLI_ITERS))
            and len(logged) == steps // CLI_LOG_EVERY
            and logged[-1]["loss"] < logged[0]["loss"]
            and params_finite(torch, state.params)
            and meta["grid_size"] == list(net.grid_size)
            and only(counts, pack_build=per_image * n_img,
                     shade=per_image * n_img)):
        raise AssertionError("67. the CLI's training run is not as "
                             "expected")
    record["train"] = {"steps": steps, "fit_s": fit_s, "call_s": call_s,
                       "step_ms": step, "val": vals,
                       "peak_rss_bytes": rss.peak, "launches": counts}
    del system, state
    torch.cuda.empty_cache()

    # ---- 68-70. --eval-only, --render-only, --export-mesh on it
    ckpt = os.path.join(run, "last")
    mesh = os.path.join(tmp, "flagship_mesh.ply")
    fresh_host("68")
    reset_counts()
    t0 = time.perf_counter()
    system, state, done = cli.main(argv + [
        "--resume", ckpt, "--eval-only", "--render-only", "--export-mesh",
        mesh])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    counts = read_counts()
    metrics, eval_s = done["eval"]["metrics"], done["eval"]["seconds"]
    # the mean over the frames after the first, as the CLI prints it
    frame_s = float(np.mean(done["spiral"]["frame_seconds"][1:]))
    spiral_s = done["spiral"]["seconds"]
    nv, nf, mesh_s = (done["mesh"][k] for k in ("verts", "faces",
                                                "seconds"))
    ds = system.val_dataset
    img_dir = os.path.join(run, "val_images", str(state.it))
    pngs = sorted(os.listdir(img_dir))
    spiral = sorted(os.listdir(os.path.join(run, "spiral")))
    mp4 = os.path.join(run, "spiral", "spiral.mp4")
    mp4_bytes = os.path.getsize(mp4) if os.path.exists(mp4) else 0
    want_k = per_image * (ds.num_images + 30)
    print(f"# 68. {card}: --eval-only on {ds.num_images} held-out images "
          f"({ds.img_wh[0]} x {ds.img_wh[1]}) in {eval_s:.2f} s: "
          f"{metrics}; {len(pngs)} PNGs", flush=True)
    print(f"# 69. {card}: --render-only, the 30-frame spiral in "
          f"{spiral_s:.2f} s (mean frame {frame_s * 1e3:.1f} ms, host "
          f"ray build, 9 chunks and the copy back included), {len(spiral)} "
          f"files, spiral.mp4 {mp4_bytes} bytes", flush=True)
    print(f"# 70. --export-mesh: {nv} vertices, {nf} faces in "
          f"{mesh_s:.2f} s (128^3 grid); the whole call "
          f"{call_s:.1f} s; launches {counts} (want {want_k} each of K1 and "
          f"K2, {per_image} per image)", flush=True)
    if not (only(counts, pack_build=want_k, shade=want_k)
            and len(pngs) == 2 * ds.num_images and len(spiral) == 31
            and mp4_bytes > 0 and nf > 0 and os.path.getsize(mesh) > 0
            and metrics["psnr"] > 5.0 and 0.0 < metrics["ssim"] <= 1.0):
        raise AssertionError("68-70. the CLI's eval, spiral or mesh is not "
                             "as expected")

    # one held-out view through the Renderer: 9 + 9 launches, its time
    # (the rays' copy in and the rgb's copy out included) and PSNR, and
    # its first chunk against the plain versions
    view = ds.image(0)
    W, H = ds.img_wh
    reset_counts()
    rgb = system.renderer.render_image(state.params, view["rays"],
                                       ds.img_wh, it=state.it)["rgb"]
    view_counts = read_counts()
    view_ms = cuda_ms(torch, lambda: system.renderer.render_rays(
        state.params, view["rays"], it=state.it), 3)
    p = psnr(torch.from_numpy(np.clip(rgb, 0, 1)),
             torch.from_numpy(view["rgb"].reshape(H, W, 3))).item()
    print(f"# 68. {card}: one held-out view through the Renderer: "
          f"{view_ms:.3f} ms ({view['rays'].shape[0]} rays; CUDA events "
          f"around render_rays, the copies included), psnr {p:.3f} dB; "
          f"launches {view_counts}", flush=True)
    if not only(view_counts, pack_build=per_image, shade=per_image):
        raise AssertionError(f"68. a view's launches {view_counts}")
    model = system.model
    model32 = build_model(resolve_model_cfg(system.cfg,
                                            system.iters_per_epoch),
                          dataset_info=system.train_dataset.info())
    model32.color_net.aabb = model.color_net.aabb
    model32.color_net.grid_size = list(model.color_net.grid_size)
    with torch.no_grad():
        prep = model.prepare_eval(state.params)
        k1, k2 = trained_flagship_chunk(
            torch, model, state.params,
            torch.from_numpy(view["rays"][:CHUNK]).to(dev),
            StepCtx(it=state.it), prep, "CLI-trained flagship", model32)
    del prep, model32
    records += flagship_entries("cli_eval", counts, k1, k2)
    record["eval"] = {"metrics": metrics, "eval_s": eval_s,
                      "view_ms": view_ms, "view_psnr": p,
                      "spiral_s": spiral_s, "spiral_frame_s": frame_s,
                      "mp4_bytes": mp4_bytes, "mesh_verts": nv,
                      "mesh_faces": nf, "mesh_s": mesh_s,
                      "launches": counts}

    # ---- 71. the viewer on the trained flagship
    with torch.no_grad():
        full = cli.viewer_models(system, state, 0, False)[:3]
        probe_db = cli.viewer_models(system, state, -1, False)[3]
        fast = cli.viewer_models(system, state, 16, False)[:3]
        patch = cli.viewer_models(system, state, 0, True)[:3]
        viewer = {"probe_db": probe_db}
        for side in VIEWER_SIDES:
            for tag, key, (model, params, patch_model) in (
                    ("full quality", "full", full),
                    ("compaction 16", "compact16", fast),
                    ("coherent gather", "patch", patch)):
                r, viewer[f"{key}_{side}"] = viewer_ladder(
                    torch, dev, card, reset_counts, read_counts, state, tag,
                    side, model, params, patch_model)
                for lv in viewer[f"{key}_{side}"]:
                    shade_k = "shade_patch" if lv["patch"] else "shade"
                    got = {n: lv["launches"].get(n, 0) for n in read_counts()}
                    if not only(got, pack_build=None, **{shade_k: None}):
                        raise AssertionError(f"71. viewer {tag} launches {lv}")
            # the full-quality frame at level 0 against the Renderer's
            # render of the same pose (its per-sample time mix: K2 TH=4)
            pose = OrbitCamera(side, side).pose
            r = InteractiveRenderer(model=full[0], params=full[1],
                                    base_wh=(side, side), ray_width=8,
                                    it=state.it, device=dev)
            r._level = 0
            img, _ = r.render_frame(pose, t=0.5)
            W, H = r._wh_for(0)
            f = H / (2.0 * np.tan(np.radians(60.0) / 2.0))
            K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                         np.float32)
            ref = Renderer(full[0], ray_chunk=CHUNK, device=dev).render_rays(
                full[1], r._host_rays(W, H, K, pose, 0.5, 1.0),
                it=state.it)["rgb"]
            ref = (np.clip(ref, 0, 1) * 255).astype(np.uint8)
            diff = int(np.abs(img.reshape(-1, 3).astype(int)
                              - ref.astype(int)).max())
            print(f"# 71. the viewer's full-quality {W}x{H} frame vs the "
                  f"Renderer's render of the same pose: max |diff| {diff} "
                  "uint8 levels (tol 1)", flush=True)
            if diff > 1:
                raise AssertionError(f"71. viewer frame vs Renderer: {diff}")
            viewer[f"vs_renderer_u8_{side}"] = diff
        viewer["patch_levels"] = {
            side: [lv["level"] for lv in viewer[f"patch_{side}"]
                   if lv["patch"]] for side in VIEWER_SIDES}
        print(f"# 71. fast_mode_probe: compaction 16 vs full "
              f"{probe_db:.2f} dB (gate 35.0); the levels that pass the "
              f"patch gate, by base side: {viewer['patch_levels']}",
              flush=True)
    record["viewer"] = viewer
    del fast, patch, r, ref
    torch.cuda.empty_cache()

    # ---- 72. the HTTP server on localhost
    server = make_server(full[0], full[1], host="127.0.0.1", port=0,
                         wh=(512, 512), ray_width=8, device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    served = []
    try:
        with opener.open(base + "/", timeout=120) as resp:
            page_ok = resp.status == 200 and b"/frame?yaw=" in resp.read()
        for yaw, pitch in SERVE_FRAMES:
            want = server.renderer._wh_for(server.renderer._level)
            with opener.open(f"{base}/frame?yaw={yaw}&pitch={pitch}&t=0.5",
                             timeout=120) as resp:
                served.append((want, png_size(resp.read()),
                               float(resp.headers["X-Frame-Time"]),
                               resp.headers["Content-Type"]))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print(f"# 72. serve on {base}: GET / {'ok' if page_ok else 'FAILED'}; "
          + "; ".join(f"/frame {got[0]}x{got[1]} (level size {want[0]}x"
                      f"{want[1]}), X-Frame-Time {ft:.3f} s"
                      for want, got, ft, _ in served), flush=True)
    if not (page_ok and not thread.is_alive() and all(
            tuple(want) == got and ctype == "image/png"
            for want, got, _, ctype in served)):
        raise AssertionError("72. the viewer's server answered wrongly")
    record["serve"] = [{"wh": list(got), "x_frame_time_s": ft}
                       for _, got, ft, _ in served]
    del system, state, full
    torch.cuda.empty_cache()

    # ---- 73. llff_z_plane through the CLI, with its visualizers
    llff_cfg = os.path.join(tmp, "llff.yaml")
    with open(llff_cfg, "w") as f:
        yaml.safe_dump({
            "params": {"seed": SEED, "save_dir": runs, "name": "llff",
                       "compute_dtype": "bfloat16"},
            "dataset": {"name": "llff", "root_dir": llff_root,
                        "downsample": 1, "use_ndc": True, "val_skip": 8},
            "model": "llff_z_plane",
            "training": {"num_iters": CLI_LLFF_ITERS, "num_epochs": 1,
                         "val_every": 1, "log_every": CLI_LOG_EVERY},
            "regularizers": tv_4000_defaults(),
            "visualizers": {"epipolar": {"type": "epipolar"},
                            "focus": {"type": "focus",
                                      "aperture_samples": 2}}}, f)
    fresh_host("73")
    reset_counts()
    t0 = time.perf_counter()
    llff_argv = ["--config", llff_cfg, "--device", str(dev)]
    system, state, _ = cli.main(llff_argv)
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
    del system, state
    fresh_host("73 eval")
    reset_counts()
    t0 = time.perf_counter()
    system, state, done = cli.main(llff_argv + [
        "--resume", os.path.join(runs, "llff", "last"), "--eval-only"])
    eval_s = time.perf_counter() - t0
    counts = read_counts()
    metrics = done["eval"]["metrics"]
    files = set(os.listdir(os.path.join(runs, "llff", "val_images",
                                        str(state.it))))
    ds = system.val_dataset
    print(f"# 73. {card}: llff_z_plane trained {CLI_LLFF_ITERS} steps "
          f"through the CLI in {train_s:.1f} s (launches {train_counts}); "
          f"--eval-only on {ds.num_images} views in {eval_s:.1f} s: "
          f"{metrics}; launches {counts}; the visualizers' images "
          f"{sorted(f for f in files if not f[:3] in ('gt_', 'pre'))}",
          flush=True)
    if not (only(train_counts, pack_build=None, shade_multi=None)
            and only(counts, pack_build=counts["shade_multi"],
                     shade_multi=None)
            and {"epi_pred.png", "focus_rgb_ray.png", "focus_rgb_cone.png",
                 "pred_000.png"} <= files):
        raise AssertionError("73. the llff CLI run is not as expected")
    chunks, gt = view_chunks(torch, dev, ds.image(0))
    recs, view = trained_multi_frame(
        torch, dev, "llff", resolve_model_cfg(system.cfg,
                                              system.iters_per_epoch),
        system.train_dataset.info(), system.model, state, chunks,
        reset_counts, read_counts, label="llff_cli", gt=gt)
    for rec in recs:          # the launches of the CLI's eval call
        rec["launches"] = counts["pack_build" if rec["name"].startswith(
            "pack_build") else "shade_multi"]
    records += recs
    record["llff"] = {"train_s": train_s, "eval_s": eval_s,
                      "metrics": metrics, "launches": counts, **view}
    del system, state, chunks, gt
    fresh_host("73 done")
    torch.cuda.empty_cache()
    return records, record

DP_STEPS = 20
DP_TIMED = 10                   # steps timed per run, after the rest
DP_FLOW_SCALE = 1.0             # the keyframe jitter on: a per-ray draw
# the averaged gradients of the first step against the one-process
# step's: each leaf within 1e-4 of its largest entry (f32 sums over 8,192
# and 16,384 rays in another order, the lookups' backward by atomics); a
# summed gradient is off by the whole leaf
DP_GRAD_TOL = 1e-4
# the params after DP_STEPS Adam steps: their distance to the one-process
# run's (L2 over every leaf) within 1e-2 of the distance that run moved
# them; the run that drops rank 1's rows must be 10x further off. (The
# largest single difference says little: Adam's first steps move a
# parameter whose gradient is a sum that cancels to ~0 by +-lr whatever
# its rounding, measured 3.7e-2 after 20 steps under the deterministic
# algorithms too.)
DP_PARAM_TOL = 1e-2
DP_WORKER_S = 600


def dp_trainer(torch, dev, cfg, info):
    """A model of `cfg` under the f32 MLP policy (DP's equality is held
    without bf16's rounding), DEFAULT_TRAINING, tv_4000: (model,
    trainer)."""
    import copy

    from hyperreel_tpu_torch.config import DEFAULT_TRAINING
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.trainer import Trainer

    model = build_model(copy.deepcopy(cfg), dataset_info=info)
    return model, Trainer(model, copy.deepcopy(DEFAULT_TRAINING),
                          regularizer_cfgs=tv_4000_defaults(),
                          iters_per_epoch=4000, device=dev)


def dp_steps(torch, dev, step, state, batches, optimizer):
    """DP_STEPS steps of `step` from the generator of seed SEED ->
    (state, ms per step over the last DP_TIMED, CUDA events)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i, b in enumerate(batches):
        if i == len(batches) - DP_TIMED:
            torch.cuda.synchronize()
            start.record()
        state, _ = step(state, b, optimizer, gen, None)
    end.record()
    torch.cuda.synchronize()
    return state, start.elapsed_time(end) / DP_TIMED


def dp_worker(setup, out, rank, world, port):
    """One rank of phase 76 (`chip_smoke.py --dp-worker SETUP OUT RANK
    WORLD PORT`): gloo on cuda:0; a probe of gloo's all-reduce and
    broadcast on tensors on the card; the first step's averaged gradients
    and DP_STEPS ShardedTrainer steps from SETUP's weights and global
    batches; OUT_<RANK>.pt gets the gradients, the params (on the host)
    and the ms per step."""
    import torch
    import torch.distributed as dist

    from hyperreel_tpu_torch.parallel.mesh import (
        ShardedTrainer, initialize_multihost)
    from hyperreel_tpu_torch.train.trainer import TrainState

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(dev, backend="gloo",
                         init_method=f"tcp://localhost:{port}",
                         world_size=world, rank=rank)
    probe = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(probe)
    ones = torch.full((2,), float(rank), device=dev)
    dist.broadcast(ones, 1)
    s = torch.load(setup, weights_only=False)
    model, trainer = dp_trainer(torch, dev, s["cfg"], s["info"])
    params = tree_to(s["params"], dev)
    state = TrainState(params, trainer.make_optimizer(params).init(params),
                       0)
    sharded = ShardedTrainer(trainer)
    state = sharded.place_state(state)
    _, grads0 = sharded.grads(state.params, s["batches"][0], 0,
                              torch.Generator(device=dev).manual_seed(SEED))
    state, ms = dp_steps(torch, dev, sharded.step, state, s["batches"],
                         trainer.make_optimizer(state.params))
    torch.save({"grads0": {k: v.cpu() for k, v in grads0.items()},
                "params": tree_to(state.params, "cpu"),
                "ms": ms, "probe": probe.tolist(), "bcast": ones.tolist()},
               f"{out}_{rank}.pt")
    dist.destroy_process_group()


def nccl_probe(rank, world, port):
    """`chip_smoke.py --nccl-probe RANK WORLD PORT`: NCCL with every rank
    on cuda:0; one all-reduce."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    x = torch.ones(4, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"rank {rank}: all-reduce gave {x.tolist()}", flush=True)
    dist.destroy_process_group()


def tree_to(tree, dev):
    """The nested dict of tensors `tree` with every tensor on `dev`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(args, world, timeout):
    """Run `chip_smoke.py ARGS RANK WORLD PORT` for each rank at once ->
    [(exit code, output)]; a rank still running at `timeout` is killed
    (exit code None)."""
    import sys
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args, str(r),
         str(world), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    out = []
    for p in procs:
        try:
            log = p.communicate(timeout=timeout)[0]
            out.append((p.returncode, log))
        except subprocess.TimeoutExpired:
            p.kill()
            out.append((None, p.communicate()[0]))
    return out


def dp_phases(torch, dev, card, tmp):
    """Phases 74-76: data parallelism. The flagship through System.fit
    with training.data_parallel=true in a process group of one rank over
    NCCL (the path a multi-card user runs, all-reduce included); NCCL's
    answer to two ranks on the one card; two ranks over gloo on the card,
    DP_STEPS steps on 16,384-ray global batches, held against one process
    on the same batches and draws. Returns the record."""
    import copy
    import itertools

    import torch.distributed as dist

    from hyperreel_tpu_torch.config import DEFAULT_TRAINING
    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, technicolor_z_plane)
    from hyperreel_tpu_torch.data.synthetic import gaussian_blob_scene
    from hyperreel_tpu_torch.parallel.mesh import initialize_multihost
    from hyperreel_tpu_torch.system import System
    from hyperreel_tpu_torch.train.optim import tree_leaves
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults

    record = {}
    B = DEFAULT_TRAINING["batch_size"]
    # ---- 74. System.fit, one rank over NCCL
    initialize_multihost(dev, init_method=f"tcp://localhost:{free_port()}",
                         world_size=1, rank=0)
    scene = {k: list(v) if isinstance(v, tuple) else v
             for k, v in TRAIN_SCENE.items()}
    cfg = {"params": {"seed": SEED, "save_dir": os.path.join(tmp, "runs"),
                      "name": "dp1", "compute_dtype": "bfloat16"},
           "dataset": {"name": "synthetic_blobs", **scene},
           "model": "technicolor_z_plane",
           "training": {**copy.deepcopy(DEFAULT_TRAINING),
                        "num_iters": DP_STEPS, "num_epochs": 1,
                        "val_every": 1, "log_every": 5,
                        "data_parallel": True},
           "regularizers": tv_4000_defaults()}
    t0 = time.perf_counter()
    system = System(cfg, device=dev)
    state, hist = system.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    sharded = system.sharded
    batches = [system.trainer.to_device(b) for b in itertools.islice(
        system.train_dataset.batch_iterator(B, seed=SEED + 5),
        DP_TIMED + 1)]
    _, ms1 = dp_steps(torch, dev, sharded.step, copy.deepcopy(state),
                      batches, system.trainer.make_optimizer(state.params))
    print(f"# 74. {card}: System.fit with training.data_parallel=true, one "
          f"rank over {dist.get_backend()} (ShardedTrainer, world "
          f"{dist.get_world_size()}): {state.it} steps of the flagship "
          f"(bf16) in {fit_s:.1f} s with the scene, a validation and the "
          f"checkpoint; loss " + ", ".join(
              f"it {m['it']} {m['loss']:.5f}" for m in hist)
          + f"; the data-parallel step {ms1:.3f} ms (CUDA events, "
          f"{DP_TIMED} steps, the all-reduce included)", flush=True)
    if not (sharded is not None and sharded.world == 1 and state.it ==
            DP_STEPS and hist and all(np.isfinite(m["loss"]) for m in hist)
            and params_finite(torch, state.params)
            and os.path.isdir(os.path.join(system.save_dir, "last"))):
        raise AssertionError("74. the data-parallel System.fit is not as "
                             "expected")
    record["nccl_world1"] = {"fit_s": fit_s, "step_ms": ms1,
                             "losses": [m["loss"] for m in hist]}
    dist.destroy_process_group()
    del system, state, batches
    torch.cuda.empty_cache()

    # ---- 75. NCCL with two ranks on the one card
    t0 = time.perf_counter()
    res = spawn_ranks(["--nccl-probe"], 2, 60)
    refused = any(rc != 0 for rc, _ in res)
    why = [line for _, log in res for line in log.splitlines()
           if "uplicate" in line or "Error" in line][:2]
    print(f"# 75. NCCL, two ranks on cuda:0: exit codes "
          f"{[rc for rc, _ in res]} in {time.perf_counter() - t0:.1f} s; "
          f"{'refused' if refused else 'not refused'}: "
          + (" | ".join(w.strip()[:200] for w in why) or res[0][1][-300:]),
          flush=True)
    record["nccl_two_ranks_one_card"] = {
        "refused": refused, "exit_codes": [rc for rc, _ in res],
        "message": why}

    # ---- 76. two ranks over gloo on the card against one process
    base = convert_epochs_to_iters(technicolor_z_plane(), 4000)
    base["embedding"]["embeddings"]["flow_0"]["flow_scale"] = DP_FLOW_SCALE
    # f32 tables: the lookups' backward sums into the table's dtype, and
    # bf16 sums of two shards round 2-3e-3 (relative) away from one sum
    # of both (a CPU run of the flagship's grids)
    base["color"]["net"]["bf16_tables"] = False
    ds = gaussian_blob_scene(**TRAIN_SCENE, device=dev)
    model, trainer = dp_trainer(torch, dev, base, ds.info())
    state0 = trainer.init_state(torch.Generator().manual_seed(SEED))
    it = ds.batch_iterator(B, seed=SEED + 6)
    glob = [next(it) for _ in range(DP_STEPS)]
    setup = os.path.join(tmp, "dp_setup.pt")
    torch.save({"cfg": base, "info": ds.info(),
                "params": tree_to(state0.params, "cpu"),
                "batches": glob}, setup)
    t0 = time.perf_counter()
    res = spawn_ranks(["--dp-worker", setup,
                       os.path.join(tmp, "dp_rank")], 2, DP_WORKER_S)
    spawn_s = time.perf_counter() - t0
    for r, (rc, log) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"76. gloo rank {r} exited {rc}:\n"
                                 f"{log[-3000:]}")
    outs = [torch.load(os.path.join(tmp, f"dp_rank_{r}.pt"),
                       weights_only=False) for r in range(2)]
    # one process on the same global batches and draws
    st = copy.deepcopy(state0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _, _, grads1 = trainer.grads(st.params, trainer.to_device(glob[0]),
                                 trainer.step_ctx(0, gen))

    def one(state, batch, opt, g, d):
        return trainer.step(state, trainer.to_device(batch), opt, g, d)

    st, ms_one = dp_steps(torch, dev, one, st, glob,
                          trainer.make_optimizer(st.params))
    # the run that drops rank 1's rows (a shard lost)
    half = [{k: v[:B // 2] for k, v in b.items()} for b in glob]
    dropped, _ = dp_steps(torch, dev, one, copy.deepcopy(state0), half,
                          trainer.make_optimizer(state0.params))
    g_err = max((outs[0]["grads0"][p] - g.cpu()).abs().max().item()
                / max(g.abs().max().item(), 1e-30)
                for p, g in grads1.items())
    g_sum = max((2 * outs[0]["grads0"][p] - g.cpu()).abs().max().item()
                / max(g.abs().max().item(), 1e-30)
                for p, g in grads1.items() if g.abs().max().item() > 0)

    def flat(tree):
        return torch.cat([v.detach().float().cpu().reshape(-1)
                          for _, v in sorted(tree_leaves(tree),
                                             key=lambda pv: pv[0])])

    one_p, p0 = flat(st.params), flat(state0.params)
    moved = (one_p - p0).norm().item()

    def p_err(tree):
        d = flat(tree) - one_p
        return d.norm().item() / moved, d.abs().max().item()

    same = (flat(outs[0]["params"]) - flat(outs[1]["params"])).abs().max(
        ).item()
    err, err_max = p_err(outs[0]["params"])
    err_drop, drop_max = p_err(dropped.params)
    print(f"# 76. {card}: two ranks over gloo on cuda:0 ({spawn_s:.1f} s "
          f"with the processes' start): gloo took tensors on the card "
          f"(all-reduce {outs[0]['probe']}, broadcast "
          f"{outs[0]['bcast']}); {DP_STEPS} steps of the flagship (f32 "
          f"MLP and tables, flow jitter {DP_FLOW_SCALE}) on {B}-ray "
          f"global batches: the first step's averaged gradients vs one "
          f"process {g_err:.3e} of each leaf's largest (tol {DP_GRAD_TOL}; "
          f"summed, they would be {g_sum:.3e} off); the params after "
          f"{DP_STEPS} steps (moved {moved:.3f} in L2 by the one-process "
          f"run): rank 0 vs rank 1 {same:.3e}; vs one process {err:.3e} of "
          f"that (tol {DP_PARAM_TOL}; largest element {err_max:.3e}), one "
          f"process without rank 1's rows {err_drop:.3e} (largest "
          f"{drop_max:.3e}); ms/step: two ranks "
          + ", ".join(f"{o['ms']:.3f}" for o in outs)
          + f", one process {ms_one:.3f} (CUDA events, {DP_TIMED} steps)",
          flush=True)
    if not (outs[0]["probe"] == [3.0] * 4 and outs[0]["bcast"] == [1.0] * 2
            and g_err <= DP_GRAD_TOL and same == 0.0
            and err <= DP_PARAM_TOL and err_drop >= 10 * DP_PARAM_TOL):
        raise AssertionError("76. two ranks over gloo disagree with one "
                             "process")
    record["gloo_world2"] = {
        "grad_err": g_err, "param_rel_l2": err, "param_max_abs": err_max,
        "dropped_shard_rel_l2": err_drop,
        "rank_ms": [o["ms"] for o in outs], "one_process_ms": ms_one}
    del model, trainer, st, dropped, ds, glob
    torch.cuda.empty_cache()
    return record


CASC_ITERS = 100                # steps an epoch of the cascaded CLI run
CASC_EPOCHS = 3
CASC_ALPHA_IT = 100
CASC_UPSAMPLE_IT = 200
CASC_FRAMES = 5                 # of the 9 frames that phase 64 writes
CASC_LOG_EVERY = 50
BLENDER_WH = (800, 800)         # the published renders' size
BLENDER_TRAIN = 20              # of the published 100 train views
BLENDER_VAL = 2                 # of the published 100 val views
BLENDER_ANGLE_X = 0.6911112070083618    # lego's camera_angle_x
BLENDER_RADIUS = 4.031128874            # the cameras' distance
BLENDER_STEPS = 40
BLENDER_ALPHA_IT = 20
# the voxel net's general chain holds ~40 floats a sample at once: 65,536
# rays x 192 samples (12.6 M samples) a chunk, not the default 262,144
BLENDER_CHUNK = 1 << 16
FAMILY_STEPS = 20               # deformable and refnerf: a few steps


def write_blender_scene(root):
    """A Blender-layout scene ("lego"): transforms_{train,val}.json with
    lego's camera_angle_x and cameras on the upper hemisphere at the
    published distance looking at the origin (OpenGL axes, z up), the
    renders smooth RGB fields at 800 x 800."""
    import json as _json

    rng = np.random.default_rng(SEED + 2)
    d = os.path.join(root, "lego")
    freqs = rng.uniform(0.5, 3.0, (3, 2))
    jobs = []
    for split, n in (("train", BLENDER_TRAIN), ("val", BLENDER_VAL)):
        os.makedirs(os.path.join(d, split))
        frames = []
        for i in range(n):
            az = rng.uniform(0, 2 * np.pi)
            el = rng.uniform(0.2, 1.2)
            p = BLENDER_RADIUS * np.array([np.cos(el) * np.cos(az),
                                           np.cos(el) * np.sin(az),
                                           np.sin(el)])
            z = p / np.linalg.norm(p)
            x = np.cross([0.0, 0.0, 1.0], z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            c2w = np.eye(4)
            c2w[:3, :4] = np.stack([x, y, z, p], 1)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
            jobs.append((os.path.join(d, split, f"r_{i}.png"), BLENDER_WH,
                         freqs, (az / (2 * np.pi), el)))
        with open(os.path.join(d, f"transforms_{split}.json"), "w") as f:
            _json.dump({"camera_angle_x": BLENDER_ANGLE_X,
                        "frames": frames}, f)
    write_images(jobs)
    return d


def family_model(torch, preset, info, **net):
    """A preset at full width, bf16 MLP policy and tables, with `net`
    updated in its colour net's config: (cfg, model)."""
    import copy

    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.models.model import build_model

    cfg = presets.convert_epochs_to_iters(getattr(presets, preset)(), 4000)
    cfg["color"]["net"].update(net)
    return cfg, build_model(copy.deepcopy(cfg), dataset_info=info,
                            compute_dtype=torch.bfloat16)


def family_fit(torch, dev, model, ds, steps, tag):
    """`steps` of Trainer.fit (DEFAULT_TRAINING, tv_4000) from the init of
    seed SEED, the model's own events: every loss and param finite.
    Returns (trainer, state, the record: fit seconds, the step's ms
    (CUDA events, 10 steps), the peak of allocated memory, the first and
    last image loss)."""
    import copy
    import itertools

    from hyperreel_tpu_torch.config import DEFAULT_TRAINING
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.trainer import Trainer

    B = DEFAULT_TRAINING["batch_size"]
    trainer = Trainer(model, copy.deepcopy(DEFAULT_TRAINING),
                      regularizer_cfgs=tv_4000_defaults(),
                      iters_per_epoch=4000, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist = trainer.fit(
        state, ds.batch_iterator(B, seed=SEED), steps,
        gen=torch.Generator(device=dev).manual_seed(SEED), log_every=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ms = step_ms(torch, trainer, state, [
        trainer.to_device(b) for b in itertools.islice(
            ds.batch_iterator(B, seed=SEED + 1), 11)], reps=10)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["image_loss"] for h in hist]
    print(f"# {tag}: {steps} steps in {fit_s:.2f} s; image loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} (first 5 "
          f"{np.mean(losses[:5]):.5f}, last 5 {np.mean(losses[-5:]):.5f}); "
          f"the step {ms:.3f} ms (CUDA events, 10 steps); peak allocated "
          f"{peak / 2**30:.3f} GiB", flush=True)
    if not (all(np.isfinite(h[k]) for h in hist for k in h)
            and params_finite(torch, state.params)):
        raise AssertionError(f"{tag}: a loss or a param is not finite")
    return trainer, state, {"fit_s": fit_s, "step_ms": ms,
                            "peak_bytes": peak, "image_loss_first_last":
                            [losses[0], losses[-1]]}


def general_clone(torch, cfg, info, model):
    """`model` with its colour net's own route off (the general colour
    net), on the trained net's aabb and grid."""
    import copy

    from hyperreel_tpu_torch.models.model import build_model

    cfg = copy.deepcopy(cfg)
    cfg["color"]["net"]["fused_render"] = False
    g = build_model(cfg, dataset_info=info, compute_dtype=torch.bfloat16)
    g.color_net.aabb = model.color_net.aabb
    g.color_net.grid_size = list(model.color_net.grid_size)
    return g


def own_route_view(torch, dev, card, reset_counts, read_counts, tag, cfg,
                   info, model, params, it, view):
    """A held-out view through model.apply (the general chain, then the
    colour net's own route: K2 for one axis, K5 for three), the launches
    once per chunk and nothing else; on its first chunk the kernel against
    its plain version (<= SHADE_TOL) and the own route against the general
    colour net (<= PATH_TOL), the second factors rounded to bf16 for both
    (bf16_second_factors), the latter over the rays with no sample on an
    aabb face (near_face; under 1 % of the chunk's rays may have one,
    unless every ray is within PATH_TOL);
    its time and bound. Returns (the kernel's JSON record, the view
    record)."""
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.ops.kernels.shade import shade, shade_plain
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        shade_multi, shade_multi_plain)
    from hyperreel_tpu_torch.train.metrics import psnr

    ctx = StepCtx(it=it)
    net = model.color_net
    p16 = bf16_second_factors(torch, params)
    chunks, gt = view_chunks(torch, dev, view)
    with torch.no_grad():
        prep = model.prepare_eval(p16)
        rk = {"cf_prepared": prep}
        one = len(prep["axes"]) == 1
        kernel = "shade" if one else "shade_multi"

        def render():
            return [model.apply(p16, c, ctx, rk)["rgb"] for c in chunks]

        reset_counts()
        rgb = torch.cat(render())
        torch.cuda.synchronize()
        counts = read_counts()
        view_ms = cuda_ms(torch, render, 2)
        p = psnr(rgb, gt).item()
        if not only(counts, **{kernel: len(chunks)}):
            raise AssertionError(f"{tag}: a view's launches {counts}")
        if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                and rgb.max() <= 1):
            raise AssertionError(f"{tag}: a view's rgb is not finite in "
                                 "[0, 1]")
        x = model.embedding.apply(p16["embedding"],
                                  model.ray_param.apply(chunks[0]), ctx, {})
        pack, rp = net.fused_pack(x)
        R = chunks[0].shape[0]
        spec = net.fused_spec(prep, pack.shape[1] // R)
        if one:
            args = (prep["quads"][0], pack, rp, prep["lines"][0],
                    prep["wb"], spec)
            fn, fn_p = shade, shade_plain
        else:
            args = (prep["quads"], prep["lines"], pack, rp, prep["wb"],
                    spec)
            fn, fn_p = shade_multi, shade_multi_plain
        out, out_p = fn(*args), fn_p(*args)
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        general = general_clone(torch, cfg, info, model)
        # over the rays with no sample within FACE_ULPS of an aabb face,
        # which the kernel's and torch's validity tests may keep or drop
        # by their last ulp (ROADMAP.md 3; shiny's z-planes anchor on the
        # faces)
        g_diff = (model.apply(p16, chunks[0], ctx, rk)["rgb"]
                  - general.apply(p16, chunks[0], ctx, {})["rgb"]
                  ).abs().amax(1)
        near = near_face(torch, pack, pack.shape[1] // R)
        # nan where every ray has a sample on a face
        g_err = g_diff[~near].max().item() if (~near).any() \
            else float("nan")
        g_all = g_diff.max().item()
        k_ms = cuda_ms(torch, lambda: fn(*args), 20)
        k_plain_ms = cuda_ms(torch, lambda: fn_p(*args), 2)
        N, valid = pack.shape[1], valid_count(pack)
        axes = prep["axes"]
        if one:
            ax = axes[0]
            bnd = sh_bound(
                f"{tag} K2", nbytes(pack, rp, prep["lines"][0]) + R * 5 * 4
                + rows_bytes(prep["quads"][0],
                             quad_rows(pack, 0, 1, ax.W, ax.H)),
                lambda f: [(valid * (shade_ops(ax.C, ax.nd, fold=f)
                                     + 8 * ax.C + 10)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], spec.S)
        else:
            rgb_colour = net.shading == "rgb"
            bnd = sh_bound(
                f"{tag} K5", pack_bytes(pack, valid)
                + ray_bytes(rp, rgb_colour, False)
                + nbytes(*prep["lines"]) + R * 5 * 4
                + sum(rows_bytes(q, quad_rows(pack, a.m0, a.m1, a.W, a.H))
                      for q, a in zip(prep["quads"], axes)),
                lambda f: [(valid * multi_ops(axes, lambda C: 8 * C + 10,
                                              rgb_colour, spec.weights,
                                              fold=f)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], spec.S)
    name = "K2" if one else "K5"
    print(f"# {tag} ({card}): a held-out view ({gt.shape[0]} rays, "
          f"{len(chunks)} chunks of at most {CHUNK}) through the general "
          f"chain and the own route: {view_ms:.3f} ms (CUDA events), psnr "
          f"{p:.3f} dB; launches {counts}; on its first chunk ({valid} of "
          f"{N} samples valid, S={spec.S}, {net.shading}"
          f"{', weights row' if spec.weights else ''}) {name} vs its plain "
          f"version rgb/acc {err:.3e}, depth {derr:.3e} (tol {SHADE_TOL}); "
          f"the own route vs the general colour net {g_err:.3e} (tol "
          f"{PATH_TOL}) over the {int((~near).sum())} rays with no sample "
          f"on an aabb face, {g_all:.3e} over all {R}; {name} {k_ms:.3f} "
          f"ms (plain {k_plain_ms:.3f}, "
          f"bound {bnd[0]:.4f} {bnd[1]}, {100 * bnd[0] / k_ms:.1f} % of "
          f"it)", flush=True)
    # the own route within PATH_TOL on every ray, or on those without a
    # sample on a face when they are under 1 % of the chunk
    own_ok = g_all <= PATH_TOL or (g_err <= PATH_TOL
                                   and near.float().mean().item() < 0.01)
    if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL and own_ok):
        raise AssertionError(f"{tag}: {name} or the own route disagrees: "
                             f"{err}, {derr}, {g_err}")
    rec = entry(f"{kernel}_{tag}", "shade.cu" if one else "shade_multi.cu",
                "hyperreel_tpu/ops/pallas/shade.py:238" if one
                else "hyperreel_tpu/ops/pallas/shade.py:742",
                counts[kernel], err, k_ms, k_plain_ms, bnd)
    del pack, rp, out, out_p, x, general
    torch.cuda.empty_cache()
    return rec, {"view_ms": view_ms, "view_psnr": p, "launches": counts,
                 "kernel_err": err, "own_vs_general": g_err,
                 "own_vs_general_all_rays": g_all,
                 "rays_on_a_face": int(near.sum())}


def family_phases(torch, dev, card, reset_counts, read_counts, tmp,
                  tech_root, llff_root):
    """Phases 77-83: the last model families at full width.
    technicolor_cascaded trained through the CLI on phase 64's scene, its
    held-out views through the Renderer and K2; blender_voxel trained
    across its alpha event on a Blender-layout scene at 800 x 800, a view
    at S = 192 through the general chain; shiny_z_deformable on phase 65's
    LLFF scene, refnerf_sphere_reflect and refnerf_sphere on the Blender
    scene, each a few steps and a view through K5 with the weights row.
    Returns (the kernels' JSON records, the record)."""
    import itertools

    import yaml

    from hyperreel_tpu_torch import main as cli
    from hyperreel_tpu_torch.config import DEFAULT_TRAINING, resolve_model_cfg
    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.data import get_dataset
    from hyperreel_tpu_torch.train.metrics import psnr
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.render import Renderer

    records, record = [], {}
    B = DEFAULT_TRAINING["batch_size"]
    runs = os.path.join(tmp, "runs")

    # ---- 77-79. technicolor_cascaded through the CLI
    cfg_path = os.path.join(tmp, "cascaded.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "params": {"seed": SEED, "save_dir": runs, "name": "cascaded",
                       "compute_dtype": "bfloat16"},
            "dataset": {"name": "technicolor", "root_dir": tech_root,
                        "img_wh": list(TECH_WH), "num_frames": CASC_FRAMES,
                        "keyframe_step": 4, "load_full_step": 8},
            "model": "technicolor_cascaded",
            "training": {"num_iters": CASC_ITERS, "num_epochs": CASC_EPOCHS,
                         "val_every": CASC_EPOCHS,
                         "log_every": CASC_LOG_EVERY},
            "regularizers": tv_4000_defaults()}, f)
    later = presets.technicolor_cascaded()["color"]["net"]["upsamp_list"][1:]
    argv = ["--config", cfg_path, "--device", str(dev),
            f"model.color.net.update_AlphaMask_list=[{CASC_ALPHA_IT}]",
            "model.color.net.upsamp_list="
            + json.dumps([CASC_UPSAMPLE_IT] + later)]
    print(f"# 77. the cut: technicolor_cascaded on {CASC_FRAMES} of phase "
          f"64's {TECH_FRAMES} frames (the rig and resolution as "
          f"published), {CASC_EPOCHS} epochs of {CASC_ITERS} steps, not "
          "4,000", flush=True)
    fresh_host("77")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system, state, done = cli.main(argv)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    run = os.path.join(runs, "cascaded")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    ds, val = system.train_dataset, system.val_dataset
    W, H = val.img_wh
    per_image = -(-W * H // system.renderer.ray_chunk)
    n_img = 2 + val.num_images
    model = system.model
    net = model.color_net
    step = step_ms(torch, system.trainer, state, [
        system.trainer.to_device(b) for b in itertools.islice(
            ds.batch_iterator(B, seed=SEED + 3), 21)])
    print(f"# 77. {card}: the CLI trained technicolor_cascaded "
          f"{state.it} steps (alpha event {CASC_ALPHA_IT}, upsample "
          f"{CASC_UPSAMPLE_IT}) in {done['fit']:.1f} s of fit "
          f"({call_s:.1f} s with the load and the validations); loss "
          + ", ".join(f"it {m['it']} {m['loss']:.5f}" for m in logged)
          + f"; grid {net.grid_size}; the step {step:.3f} ms (CUDA "
          f"events, 20 steps); peak allocated {peak / 2**30:.3f} GiB; "
          f"held-out {val.num_images} views: {done['final']}; the "
          f"validations' launches {counts}", flush=True)
    if not (state.it == CASC_ITERS * CASC_EPOCHS
            and logged[-1]["loss"] < logged[0]["loss"]
            and params_finite(torch, state.params)
            and only(counts, shade=per_image * n_img)):
        raise AssertionError("77. the cascaded CLI run is not as expected")
    # ---- 78. a held-out view through the Renderer
    view = val.image(0)
    reset_counts()
    rgb = system.renderer.render_image(state.params, view["rays"],
                                       val.img_wh, it=state.it)["rgb"]
    view_counts = read_counts()
    view_ms = cuda_ms(torch, lambda: system.renderer.render_rays(
        state.params, view["rays"], it=state.it), 2)
    p = psnr(torch.from_numpy(np.clip(rgb, 0, 1)),
             torch.from_numpy(view["rgb"].reshape(H, W, 3))).item()
    print(f"# 78. {card}: a held-out view through the Renderer "
          f"{view_ms:.3f} ms (CUDA events, the copies included), psnr "
          f"{p:.3f} dB; launches {view_counts}", flush=True)
    if not only(view_counts, shade=per_image):
        raise AssertionError(f"78. a view's launches {view_counts}")
    # ---- 79. K2 of the trained model's chunk, the own route vs the
    # general chain
    mcfg = resolve_model_cfg(system.cfg, system.iters_per_epoch)
    rec, rview = own_route_view(
        torch, dev, card, reset_counts, read_counts, "cascaded", mcfg,
        ds.info(), model, state.params, state.it, view)
    records.append(rec)
    record["cascaded"] = {
        "steps": state.it, "fit_s": done["fit"], "call_s": call_s,
        "step_ms": step, "peak_bytes": peak, "final": done["final"],
        "renderer_view_ms": view_ms, "renderer_view_psnr": p,
        "val_launches": counts, **rview}
    del system, state, model, net, ds, val, view, rgb
    torch.cuda.empty_cache()

    # ---- 80-81. blender_voxel on a Blender scene at 800 x 800
    t0 = time.perf_counter()
    broot = write_blender_scene(tmp)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bds = get_dataset("blender", broot, split="train", img_wh=BLENDER_WH)
    bval = get_dataset("blender", broot, split="val", img_wh=BLENDER_WH)
    load_s = time.perf_counter() - t0
    print(f"# 80. the cut: {BLENDER_TRAIN} train and {BLENDER_VAL} val "
          f"views of the published 100 and 100, at the published "
          f"{BLENDER_WH[0]} x {BLENDER_WH[1]}; written in {write_s:.1f} s, "
          f"loaded in {load_s:.1f} s; {bds.num_rays} train rays; "
          f"dataset_info {bds.info()}", flush=True)
    cfg, model = family_model(torch, "blender_voxel", bds.info(),
                              update_AlphaMask_list=[BLENDER_ALPHA_IT])
    aabb0 = np.array(model.color_net.aabb)
    trainer, state, rec = family_fit(torch, dev, model, bds, BLENDER_STEPS,
                                     "80. blender_voxel")
    net = model.color_net
    print(f"# 80. the alpha event at {BLENDER_ALPHA_IT}: aabb "
          f"{aabb0.tolist()} -> {np.asarray(net.aabb).tolist()}, grid "
          f"{net.grid_size}", flush=True)
    # ---- 81. a held-out view at S = 192 through the general chain
    renderer = Renderer(model, ray_chunk=BLENDER_CHUNK, device=dev)
    view = bval.image(0)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rgb = renderer.render_image(state.params, view["rays"], bds.img_wh,
                                it=state.it)["rgb"]
    render_peak = torch.cuda.max_memory_allocated()
    v_counts = read_counts()
    v_ms = cuda_ms(torch, lambda: renderer.render_rays(
        state.params, view["rays"], it=state.it), 1)
    # the device's busy time over one chunk under torch.profiler, against
    # the chunk's time without it (CUDA events): the profiler's own host
    # work would stretch a span read under it
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    one = view["rays"][:BLENDER_CHUNK]
    span = cuda_ms(torch, lambda: renderer.render_rays(
        state.params, one, it=state.it), 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        renderer.render_rays(state.params, one, it=state.it)
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    W, H = bval.img_wh
    p = psnr(torch.from_numpy(np.clip(rgb, 0, 1)),
             torch.from_numpy(view["rgb"].reshape(H, W, 3))).item()
    S = [s for n, s in model.embedding.stages
         if n == "ray_intersect_0"][0].z_channels
    idle = None if busy <= 0 else max(0.0, 1.0 - busy / span)
    print(f"# 81. {card}: a held-out view ({W} x {H}, S = {S}, chunks of "
          f"{BLENDER_CHUNK} rays) through the general chain and the "
          f"softplus net: {v_ms:.3f} ms (CUDA events), psnr {p:.3f} dB, "
          f"peak allocated {render_peak / 2**30:.3f} GiB; launches "
          f"{v_counts} (no kernel: the net is not fused-eligible); one "
          f"chunk {span:.3f} ms (CUDA events), of which the device is busy "
          f"{busy:.3f} ms (torch.profiler), idle share "
          + ("not measured" if idle is None else f"{100 * idle:.1f} %"),
          flush=True)
    if not (S == 192 and only(v_counts) and np.isfinite(rgb).all()
            and net.fea2dense == "softplus"):
        raise AssertionError("81. the voxel view is not as expected")
    record["blender_voxel"] = {**rec, "view_ms": v_ms, "view_psnr": p,
                               "render_peak_bytes": render_peak,
                               "busy_ms": busy, "span_ms": span,
                               "idle_share": idle,
                               "aabb": np.asarray(net.aabb).tolist()}
    del trainer, state, model, renderer, rgb
    torch.cuda.empty_cache()

    # ---- 82. refnerf_sphere_reflect and refnerf_sphere on the Blender
    # scene
    for preset in ("refnerf_sphere_reflect", "refnerf_sphere"):
        cfg, model = family_model(torch, preset, bds.info())
        trainer, state, rec = family_fit(torch, dev, model, bds,
                                         FAMILY_STEPS, f"82. {preset}")
        krec, rview = own_route_view(
            torch, dev, card, reset_counts, read_counts, preset, cfg,
            bds.info(), model, state.params, state.it, bval.image(0))
        records.append(krec)
        record[preset] = {**rec, **rview}
        del trainer, state, model
        torch.cuda.empty_cache()
    del bds, bval

    # ---- 83. shiny_z_deformable on phase 65's LLFF scene
    kw = dict(downsample=1, use_ndc=True, val_skip=8)
    lds = get_dataset("llff", llff_root, split="train", **kw)
    lval = get_dataset("llff", llff_root, split="val", **kw)
    cfg, model = family_model(torch, "shiny_z_deformable", lds.info())
    trainer, state, rec = family_fit(torch, dev, model, lds, FAMILY_STEPS,
                                     "83. shiny_z_deformable")
    krec, rview = own_route_view(
        torch, dev, card, reset_counts, read_counts, "shiny_z_deformable",
        cfg, lds.info(), model, state.params, state.it, lval.image(1))
    records.append(krec)
    record["shiny_z_deformable"] = {**rec, **rview}
    del trainer, state, model, lds, lval
    torch.cuda.empty_cache()
    return records, record


# ---- phases 84-86: SH of degree 0-4 in the six shade kernels

SH_DEGREES = (0, 1, 3, 4)
SH_FRAME_DEGREES = {"flagship": 3, "llff": 4}  # the frames of phase 86
SH_TIMED_FRAMES = 3


def with_degree(torch, cfg, params, deg, info=None, patch=None):
    """cfg's model with SH of degree `deg` (data_dim_color 3 (deg + 1)^2)
    on params whose basis is redrawn for it (torch.Generator seed SEED +
    deg, the nn.Linear init): (cfg, model, params, prepared tables), with
    `patch` (px, py, R) on the coherent patch-gather route."""
    import copy

    from hyperreel_tpu_torch.configs.presets import with_coherent_gather
    from hyperreel_tpu_torch.models.mlp import linear_init
    from hyperreel_tpu_torch.models.model import build_model

    cfg = copy.deepcopy(cfg)
    cfg["color"]["net"]["data_dim_color"] = 3 * (deg + 1) ** 2
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    model = build_model(cfg, dataset_info=info, compute_dtype=torch.bfloat16)
    w = params["color"]["basis_mat"]["weight"]
    basis = linear_init(torch.Generator().manual_seed(SEED + deg),
                        w.shape[1], 3 * (deg + 1) ** 2, w.device,
                        bias=False)
    params = dict(params, color=dict(params["color"], basis_mat=basis))
    return cfg, model, params, model.prepare_eval(params)


def sh_check(tag, out, ref):
    """max |kernel - plain| of rgb/acc and of depth, held to SHADE_TOL."""
    err = (out[:, :4] - ref[:, :4]).abs().max().item()
    derr = (out[:, 4] - ref[:, 4]).abs().max().item()
    if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL):
        raise AssertionError(f"{tag} disagrees with its plain version: "
                             f"{err}, {derr}")
    return err


def sh_single_phase(torch, dev, card, frame, reset_counts, read_counts):
    """Phase 84: the flagship's chunk through model.apply at SH degrees 0,
    1, 3 and 4 (the basis redrawn for each) on the quad route (K1, K2), the
    fused patch route (K3) and the two-kernel patch route (K4, K2-pre) at R
    = 8 (5, 2) on the phase-major chunk; then K2, K2-preblended and K3 on
    that chunk's pack against their plain versions, timed (CUDA events),
    each with its bound at that degree. Returns the kernels' records."""
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        PatchSpec, patch_blend)
    from hyperreel_tpu_torch.ops.kernels.shade import (
        ShadeSpec, premix_time, shade, shade_plain, shade_preblended,
        shade_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_patch import (
        shade_patch, shade_patch_plain)

    ctx = StepCtx(it=IT)
    cfg, info, model, params, prep = flagship(dev)
    cf = model._cf_eval
    R8 = PATCH_R8[2]
    chunk, chunk_pm = frame[0], phase_major(frame, R8)[0].contiguous()
    rp, rp_pm = cf.ray_pack(chunk), cf.ray_pack(chunk_pm)
    pack = pack_build(cf.pred.net_input(chunk, ctx).float().contiguous(),
                      prep["mlp"], rp, cf.spec, IT)
    pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                         .contiguous(), prep["mlp"], rp_pm, cf.spec, IT)
    H, W, TH, TW, C, nd = prep["dims"]
    ttab = premix_time(prep["ttab"], rp[0, 7])
    _, prep8 = patch_model(cfg, info, params, PATCH_R8)
    ps = PatchSpec(R=R8, px=PATCH_R8[0], py=PATCH_R8[1], W=W, H=H, C=C,
                   S=cf.S, phase_major=True)
    (feats,), _ = patch_blend([prep8["patch"]], pack_pm, [ps])
    N = pack.shape[1]
    valid, valid_pm = valid_count(pack), valid_count(pack_pm)
    out_bytes = CHUNK * 5 * 4
    records = []
    for deg in SH_DEGREES:
        nb = (deg + 1) ** 2
        _, m_d, p_d, prep_d = with_degree(torch, cfg, params, deg, info)
        _, m8_d, _, prep8_d = with_degree(torch, cfg, params, deg, info,
                                          PATCH_R8)
        counts = {}
        for route, env, m, x, rkw in (
                ("quad", "1", m_d, chunk, {"cf_prepared": prep_d}),
                ("fused", "1", m8_d, chunk_pm, {"cf_prepared": prep8_d,
                                                "rays_phase_major": True}),
                ("two", "0", m8_d, chunk_pm, {"cf_prepared": prep8_d,
                                              "rays_phase_major": True})):
            with EnvVar("HYPERREEL_FUSED_PATCH", env):
                reset_counts()
                out = m.apply(p_d, x, ctx, {**rkw, "uniform_time": True})
                torch.cuda.synchronize()
                counts[route] = read_counts()
            if not (torch.isfinite(out["rgb"]).all()
                    and out["rgb"].shape == (CHUNK, 3)):
                raise AssertionError(f"SH {deg} {route}: rgb not finite")
        want = {"quad": {"pack_build": 1, "shade": 1},
                "fused": {"pack_build": 1, "shade_patch": 1},
                "two": {"pack_build": 1, "patch_blend": 1,
                        "shade_preblended": 1}}
        for route, got in counts.items():
            if {k: v for k, v in got.items() if v} != want[route]:
                raise AssertionError(f"SH {deg} {route}: launches {got}")
        wb = prep_d["wb"]
        spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd, deg=deg,
                         distance_scale=cf.net.distance_scale)
        fns = {
            "shade": (lambda: shade(prep["quad"], pack, rp, ttab, wb, spec),
                      lambda: shade_plain(prep["quad"], pack, rp, ttab, wb,
                                          spec)),
            "shade_preblended": (
                lambda: shade_preblended(feats, pack_pm, rp_pm, ttab, wb,
                                         spec),
                lambda: shade_preblended_plain(feats, pack_pm, rp_pm, ttab,
                                               wb, spec)),
            "shade_patch": (
                lambda: shade_patch(prep8["patch"], pack_pm, rp_pm, ttab, wb,
                                    spec, ps)[0],
                lambda: shade_patch_plain(prep8["patch"], pack_pm, rp_pm,
                                          ttab, wb, spec, ps)[0])}
        bounds = {
            "shade": sh_bound(
                f"flagship K2 SH {deg}", nbytes(pack, rp, ttab) + out_bytes
                + rows_bytes(prep["quad"], quad_rows(pack, 0, 1, W, H)),
                lambda f: [(valid * (shade_ops(C, nd, fold=f, nb=nb)
                                     + 8 * C + 10) + N * COMPOSITE_OPS,
                            F32_OPS_PER_S)], cf.S),
            "shade_preblended": sh_bound(
                f"flagship K2-pre SH {deg}",
                nbytes(feats, pack_pm, rp_pm, ttab) + out_bytes,
                lambda f: [(valid_pm * shade_ops(C, nd, fold=f, nb=nb)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S),
            "shade_patch": sh_bound(
                f"flagship K3 SH {deg}", nbytes(pack_pm, rp_pm, ttab)
                + out_bytes + 4 + rows_bytes(
                    prep8["patch"], patch_rows(pack_pm, ps, False)),
                lambda f: [(valid_pm * (shade_ops(C, nd, fold=f, nb=nb)
                                        + 8 * C + 22) + N * COMPOSITE_OPS,
                            F32_OPS_PER_S)], cf.S)}
        launches = {"shade": counts["quad"]["shade"],
                    "shade_preblended": counts["two"]["shade_preblended"],
                    "shade_patch": counts["fused"]["shade_patch"]}
        source = {"shade": ("shade.cu", "shade.py:238"),
                  "shade_preblended": ("shade.cu", "shade.py:259"),
                  "shade_patch": ("shade_patch.cuh", "shade.py:282")}
        line = []
        for name, (kern, plain) in fns.items():
            err = sh_check(f"{name} SH {deg}", kern(), plain())
            ms = cuda_ms(torch, kern, 20)
            plain_ms = cuda_ms(torch, plain, 1)
            b = bounds[name]
            records.append(entry(
                f"{name} sh{deg}", source[name][0],
                f"hyperreel_tpu/ops/pallas/{source[name][1]}",
                launches[name], err, ms, plain_ms, b))
            line.append(f"{name} {ms:.3f} ms (plain {plain_ms:.3f}, bound "
                        f"{b[0]:.4f} {b[1]}, err {err:.2e}, launches "
                        f"{launches[name]})")
        print(f"# 84. {card}: flagship chunk at SH degree {deg} ({nb} "
              f"bases): " + "; ".join(line), flush=True)
        del m_d, m8_d, prep_d, prep8_d
    del pack, pack_pm, feats
    torch.cuda.empty_cache()
    return records


def sh_multi_phase(torch, dev, card, frame, reset_counts, read_counts):
    """Phase 85: llff_z_plane's chunk (checkpoint grid) through model.apply
    at SH degrees 0, 1, 3 and 4 on the quad route (K1, K5), the fused
    patch route (K6) and the two-kernel patch route (K4, K5-pre) at R = 8
    (5, 2); then K5, K5-preblended and K6 on the phase-major chunk's pack
    (as phase 10 times them) against their plain versions, timed, each
    with its bound at that degree. Returns the kernels' records."""
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build
    from hyperreel_tpu_torch.ops.kernels.patch_blend import patch_blend
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        MultiSpec, shade_multi, shade_multi_plain, shade_multi_preblended,
        shade_multi_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
        shade_multi_patch, shade_multi_patch_plain)

    ctx = StepCtx(it=IT)
    cfg, model, params, prep = static_model(dev, "llff")
    _, model8, _, prep8 = static_model(dev, "llff", patch=PATCH_R8,
                                       params=params)
    cf = model._cf_eval
    axes, lines = prep["axes"], prep["lines"]
    R8 = PATCH_R8[2]
    frame6 = frame[..., :6].contiguous()
    chunk, chunk_pm = frame6[0], phase_major(frame6, R8)[0].contiguous()
    rp_pm = cf.ray_pack(chunk_pm)
    pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                         .contiguous(), prep["mlp"], rp_pm, cf.spec, IT)
    pspecs = model8._cf_eval.patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], True)
    feats = patch_blend(prep8["ptabs"], pack_pm, pspecs)[0]
    N = pack_pm.shape[1]
    valid_pm = valid_count(pack_pm)
    shared = nbytes(*lines) + CHUNK * 5 * 4
    quad_bytes = sum(rows_bytes(q, quad_rows(pack_pm, a.m0, a.m1, a.W, a.H))
                     for q, a in zip(prep["quads"], axes))
    ptab_bytes = sum(rows_bytes(t, patch_rows(pack_pm, ps, False))
                     for t, ps in zip(prep8["ptabs"], pspecs))
    records = []
    for deg in SH_DEGREES:
        nb = (deg + 1) ** 2
        _, m_d, p_d, prep_d = with_degree(torch, cfg, params, deg)
        _, m8_d, _, prep8_d = with_degree(torch, cfg, params, deg,
                                          patch=PATCH_R8)
        counts = {}
        for route, env, m, x, rkw in (
                ("quad", "0", m_d, chunk, {"cf_prepared": prep_d}),
                ("fused", "1", m8_d, chunk_pm, {"cf_prepared": prep8_d,
                                                "rays_phase_major": True}),
                ("two", "0", m8_d, chunk_pm, {"cf_prepared": prep8_d,
                                              "rays_phase_major": True})):
            with EnvVar("HYPERREEL_FUSED_PATCH_MULTI", env):
                reset_counts()
                out = m.apply(p_d, x, ctx, rkw)
                torch.cuda.synchronize()
                counts[route] = read_counts()
            if not (torch.isfinite(out["rgb"]).all()
                    and out["rgb"].shape == (CHUNK, 3)):
                raise AssertionError(f"llff SH {deg} {route}: rgb not "
                                     "finite")
        want = {"quad": {"pack_build": 1, "shade_multi": 1},
                "fused": {"pack_build": 1, "shade_multi_patch": 1},
                "two": {"pack_build": 1, "patch_blend": 1,
                        "shade_multi_preblended": 1}}
        for route, got in counts.items():
            if {k: v for k, v in got.items() if v} != want[route]:
                raise AssertionError(f"llff SH {deg} {route}: launches "
                                     f"{got}")
        wb = prep_d["wb"]
        spec = MultiSpec(S=cf.S, axes=axes, deg=deg,
                         distance_scale=cf.net.distance_scale)
        fns = {
            "shade_multi": (
                lambda: shade_multi(prep["quads"], lines, pack_pm, rp_pm, wb,
                                    spec),
                lambda: shade_multi_plain(prep["quads"], lines, pack_pm,
                                          rp_pm, wb, spec)),
            "shade_multi_preblended": (
                lambda: shade_multi_preblended(feats, lines, pack_pm, rp_pm,
                                               wb, spec),
                lambda: shade_multi_preblended_plain(
                    feats, lines, pack_pm, rp_pm, wb, spec)),
            "shade_multi_patch": (
                lambda: shade_multi_patch(prep8["ptabs"], lines, pack_pm,
                                          rp_pm, wb, spec, pspecs)[0],
                lambda: shade_multi_patch_plain(
                    prep8["ptabs"], lines, pack_pm, rp_pm, wb, spec,
                    pspecs)[0])}
        bounds = {
            "shade_multi": sh_bound(
                f"llff K5 SH {deg}",
                shared + nbytes(pack_pm, rp_pm) + quad_bytes,
                lambda f: [(valid_pm * multi_ops(axes, lambda C: 8 * C + 10,
                                              fold=f, nb=nb)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S),
            "shade_multi_preblended": sh_bound(
                f"llff K5-pre SH {deg}",
                shared + nbytes(pack_pm, rp_pm, *feats),
                lambda f: [(valid_pm * multi_ops(axes, lambda C: C, fold=f,
                                                 nb=nb)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S),
            "shade_multi_patch": sh_bound(
                f"llff K6 SH {deg}",
                shared + nbytes(pack_pm, rp_pm) + ptab_bytes + 4,
                lambda f: [(valid_pm * multi_ops(axes, lambda C: 8 * C + 22,
                                                 fold=f, nb=nb)
                            + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)}
        launches = {"shade_multi": counts["quad"]["shade_multi"],
                    "shade_multi_preblended":
                        counts["two"]["shade_multi_preblended"],
                    "shade_multi_patch": counts["fused"]["shade_multi_patch"]}
        source = {"shade_multi": ("shade_multi.cu", "shade.py:742"),
                  "shade_multi_preblended": ("shade_multi.cu",
                                             "shade.py:761"),
                  "shade_multi_patch": ("shade_multi_patch.cu",
                                        "shade.py:786")}
        line = []
        for name, (kern, plain) in fns.items():
            err = sh_check(f"llff {name} SH {deg}", kern(), plain())
            ms = cuda_ms(torch, kern, 20)
            plain_ms = cuda_ms(torch, plain, 1)
            b = bounds[name]
            records.append(entry(
                f"{name} sh{deg}", source[name][0],
                f"hyperreel_tpu/ops/pallas/{source[name][1]}",
                launches[name], err, ms, plain_ms, b))
            line.append(f"{name} {ms:.3f} ms (plain {plain_ms:.3f}, bound "
                        f"{b[0]:.4f} {b[1]}, err {err:.2e}, launches "
                        f"{launches[name]})")
        print(f"# 85. {card}: llff chunk at SH degree {deg} ({nb} bases): "
              + "; ".join(line), flush=True)
        del m_d, m8_d, prep_d, prep8_d
    del pack_pm, feats, prep, prep8, model, model8
    torch.cuda.empty_cache()
    return records


def sh_frame_phase(torch, dev, card, frame, reset_counts, read_counts,
                   frame_ms):
    """Phase 86: the bench frame of technicolor_z_plane at SH degree 3
    (data_dim_color 48) on the quad, fused patch and two-kernel patch
    routes and through its net's own fused route, and of llff_z_plane at
    degree 4 (75) on its quad, fused and two-kernel patch routes: the
    launches, each patch route's rgb within 2e-4 of the quad route's
    frame (the witness at its gate), the quad route within 2e-4 of the
    general path on 4096 rays (f32 MLP policy), the own route within 2e-4
    of the general colour net on a chunk; each frame's ms beside degree
    2's (`frame_ms`, phases 8 and 13). Returns {route: ms/frame}."""
    import copy

    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model

    ctx = StepCtx(it=IT)
    out_ms = {}
    rays = torch.from_numpy(entry_rays(4096)).to(dev)
    for family in ("flagship", "llff"):
        deg = SH_FRAME_DEGREES[family]
        if family == "flagship":
            cfg, info, _, params, _ = flagship(dev)
            frames, shape = frame, PATCH_R8
            env_name, fused_env, two_env = "HYPERREEL_FUSED_PATCH", "1", "0"
            quad_k, fused_k = "shade", "shade_patch"
            two_k = ("patch_blend", "shade_preblended")
            rk = {"uniform_time": True}
        else:
            cfg, _, params, _ = static_model(dev, "llff")
            info = None
            # R = 4 (4, 3): the shape whose witness passes on llff's frame
            # (phase 11)
            frames, shape = frame[..., :6].contiguous(), PATCH_R4
            env_name, fused_env, two_env = ("HYPERREEL_FUSED_PATCH_MULTI",
                                            "1", "0")
            quad_k, fused_k = "shade_multi", "shade_multi_patch"
            two_k = ("patch_blend", "shade_multi_preblended")
            rk = {}
        R8 = shape[2]
        frames_pm = phase_major(frames, R8).contiguous()
        cfg_d, m_d, p_d, prep_d = with_degree(torch, cfg, params, deg, info)
        _, m8_d, _, prep8_d = with_degree(torch, cfg, params, deg, info,
                                          shape)
        n = frames.shape[0]
        routes = {
            "quad": (fused_env if family == "flagship" else "0", m_d,
                     frames, {**rk, "cf_prepared": prep_d},
                     {quad_k: n}, None),
            "fused patch": (fused_env, m8_d, frames_pm,
                            {**rk, "cf_prepared": prep8_d,
                             "rays_phase_major": True}, {fused_k: n}, R8),
            "two-kernel patch": (two_env, m8_d, frames_pm,
                                 {**rk, "cf_prepared": prep8_d,
                                  "rays_phase_major": True},
                                 {k: n for k in two_k}, R8)}
        rgb_quad = None
        for route, (env, m, fr, rkw, kern, R) in routes.items():
            def render():
                return [m.apply(p_d, fr[i], ctx, rkw) for i in range(n)]
            with EnvVar(env_name, env):
                reset_counts()
                outs = render()
                torch.cuda.synchronize()
                got = read_counts()
                ms = cuda_ms(torch, render, SH_TIMED_FRAMES)
            want = dict.fromkeys(got, 0)
            want.update(pack_build=n, **kern)
            if got != want:
                raise AssertionError(f"{family} SH {deg} {route}: launches "
                                     f"{got}, want {want}")
            rgb = torch.cat([scanline(o["rgb"], R) if R else o["rgb"]
                             for o in outs])
            if not (torch.isfinite(rgb).all() and rgb.min() >= 0
                    and rgb.max() <= 1):
                raise AssertionError(f"{family} SH {deg} {route}: rgb not "
                                     "finite in [0, 1]")
            msg = ""
            if R is None:
                rgb_quad = rgb
            else:
                pviol = max(float(o["patch_coverage_viol"]) for o in outs)
                err = (rgb - rgb_quad).abs().max().item()
                msg = (f"; R={R8} {shape[:2]}: witness {pviol:.3e}, rgb vs "
                       f"quad {err:.3e} (tol {PATH_TOL})")
                if not (pviol <= PVIOL_EXACT and err <= PATH_TOL):
                    raise AssertionError(f"{family} SH {deg} {route}: "
                                         f"witness {pviol}, rgb {err} off "
                                         "the quad route's")
            key = route if family == "flagship" else f"llff {route}"
            out_ms[f"{key} SH {deg}"] = ms
            print(f"# 86. {card}: {family} SH {deg} {route}: {ms:.3f} "
                  f"ms/frame ({SH_TIMED_FRAMES} frames; degree 2: "
                  f"{frame_ms.get(key, float('nan')):.3f}); launches {got}"
                  + msg, flush=True)
        # the quad route against the general path, f32 MLP policy
        cfg32 = copy.deepcopy(cfg_d)
        g_cfg = copy.deepcopy(cfg_d)
        g_cfg["color"]["net"].update(fused_render_cf=False,
                                     fused_render=False)
        fused32 = build_model(cfg32, dataset_info=info)
        general = build_model(g_cfg, dataset_info=info)
        x = rays if family == "flagship" else rays[:, :6].contiguous()
        a = fused32.apply(p_d, x, ctx)["rgb"]
        b = general.apply(p_d, x, ctx)["rgb"]
        path_err = (a - b).abs().max().item()
        msg = f"quad route vs general path (f32 MLP) {path_err:.3e}"
        if not path_err <= PATH_TOL:
            raise AssertionError(f"{family} SH {deg}: {msg}")
        if family == "flagship":
            # the net's own route (the general chain, then K2) against the
            # general colour net on the bench frame's first chunk
            own_cfg = copy.deepcopy(cfg_d)
            own_cfg["color"]["net"]["fused_render_cf"] = False
            own = build_model(own_cfg, dataset_info=info,
                              compute_dtype=torch.bfloat16)
            gen_cfg = copy.deepcopy(own_cfg)
            gen_cfg["color"]["net"]["fused_render"] = False
            gen_net = build_model(gen_cfg, dataset_info=info,
                                  compute_dtype=torch.bfloat16)
            oprep = own.prepare_eval(p_d)
            reset_counts()
            o = own.apply(p_d, frames[0], ctx, {"cf_prepared": oprep})["rgb"]
            torch.cuda.synchronize()
            got = read_counts()
            g = gen_net.apply(p_d, frames[0], ctx)["rgb"]
            own_err = (o - g).abs().max().item()
            ms = cuda_ms(torch, lambda: [own.apply(
                p_d, frames[i], ctx, {"cf_prepared": oprep})
                for i in range(n)], 1)
            out_ms[f"own route SH {deg}"] = ms
            msg += (f"; own route (K2 after the general chain) vs the general "
                    f"colour net on a chunk {own_err:.3e}, launches {got}, "
                    f"{ms:.3f} ms/frame")
            if {k: v for k, v in got.items() if v} != {"shade": 1} \
                    or not own_err <= PATH_TOL:
                raise AssertionError(f"flagship SH {deg} own route: {msg}")
            del own, gen_net, oprep
        print(f"# 86. {card}: {family} SH {deg}: {msg}", flush=True)
        del m_d, m8_d, prep_d, prep8_d, fused32, general
        torch.cuda.empty_cache()
    return out_ms


# ---- phases 87-91: the colour side's other heads, transforms and nets

CT_WH = (512, 272)              # the rig's 2048 x 1088 at a quarter
CT_FRAMES = 2
CT_ITERS = 600
CT_GAIN = (0.5, 1.5)            # each camera's colour gains, uniform
HEAD_STEPS = 20
EXTRA_GRID = 128                # tensor_vm, tensor_cp: a 128^3 grid
EXTRA_UPSAMPLE = 160
STANDALONE_RAYS = 4096          # the standalone net marches 128 samples


def write_gained_scene(root, gains, frames=CT_FRAMES):
    """A Technicolor scene as write_technicolor_scene writes it, at CT_WH
    and `frames` frames, each camera's images times its colour gains [16,
    3] (a rig whose cameras are calibrated apart)."""
    rng = np.random.default_rng(SEED)
    d = os.path.join(root, "gained")
    os.makedirs(os.path.join(d, "images"))
    lines = ["focal cx cy aspect skew qw qx qy qz d1 d2 tx ty tz\n"]
    n = TECH_RIG * TECH_RIG
    for c in range(n):
        q = np.array([1.0, *rng.normal(0, 0.005, 3)])
        q /= np.linalg.norm(q)
        t = [0.1 * (c % TECH_RIG - 1.5), 0.1 * (c // TECH_RIG - 1.5),
             rng.normal(0, 0.005)]
        lines.append(" ".join(repr(float(v)) for v in [
            1800.0, 1024.0, 544.0, 1.0, 0.0, *q, 0.0, 0.0, *t]) + "\n")
    with open(os.path.join(d, "cameras_parameters.txt"), "w") as f:
        f.writelines(lines)
    freqs = rng.uniform(0.5, 3.0, (3, 2))
    for fi in range(frames):
        for c in range(n):
            img = smooth_image(CT_WH, freqs, (0.3 * (c % TECH_RIG)
                                              + 0.05 * fi,
                                              0.3 * (c // TECH_RIG)))
            img = np.clip(img * gains[c] + 0.5, 0, 255).astype(np.uint8)
            write_png(os.path.join(d, "images",
                                   f"frame_{fi:04d}_cam_{c:02d}.png"), img)
    return d


def with_color_transform(cfg):
    """The flagship chain with a color_transform stage before its
    extract_fields, which then keeps the global transform and shift."""
    import copy

    cfg = copy.deepcopy(cfg)
    stages = {}
    for name, st in cfg["embedding"]["embeddings"].items():
        if st["type"] == "extract_fields":
            stages["color_transform_0"] = {"type": "color_transform"}
            st["fields"] = list(st["fields"]) + [
                "color_transform_global", "color_shift_global"]
        stages[name] = st
    cfg["embedding"]["embeddings"] = stages
    return cfg


def colour_training_phases(torch, dev, card, reset_counts, read_counts,
                           tmp):
    """Phases 87-91. 87: the flagship with a color_transform stage trained
    through the CLI (System.fit) on a 4 x 4 rig whose cameras' images
    carry colour gains, the learned transforms against the gains, and its
    held-out rays through its net's own route (K2, then the global
    transform) against the general colour net. 88-89: neural_3d_z_plane
    with DensityFourier and RGBtFourier, the flagship with MLP_Fea: a few
    steps and an eval chunk each (the general chain). 90: tensor_vm and
    tensor_cp at the JAX defaults' components on a 128^3 grid, 91: the
    standalone tensor_vm_split march: a step, an upsample, steps. Returns
    (the kernels' records, the record)."""
    import copy
    import itertools

    import yaml

    from hyperreel_tpu_torch import main as cli
    from hyperreel_tpu_torch.config import (
        DEFAULT_TRAINING, resolve_model_cfg)
    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.data.synthetic import gaussian_blob_scene
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.tensorf import build_color_net
    from hyperreel_tpu_torch.train.optim import build_optimizer, tree_leaves
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.trainer import Trainer

    records, record = [], {}
    B = DEFAULT_TRAINING["batch_size"]

    # ---- 87. the colour transform stage through the CLI
    gains = np.random.default_rng(SEED + 7).uniform(*CT_GAIN, (16, 3))
    root = write_gained_scene(tmp, gains)
    model_cfg = with_color_transform(presets.technicolor_z_plane())
    # the alpha event halfway (its shrink takes the z-planes off the aabb's
    # faces, as the cascaded run's at 100), no upsample
    model_cfg["color"]["net"].update(upsamp_list=[],
                                     update_AlphaMask_list=[CT_ITERS // 2])
    cfg_path = os.path.join(tmp, "ct.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "params": {"seed": SEED, "save_dir": os.path.join(tmp, "runs"),
                       "name": "ct", "compute_dtype": "bfloat16"},
            "dataset": {"name": "technicolor", "root_dir": root,
                        "img_wh": list(CT_WH), "num_frames": CT_FRAMES,
                        "keyframe_step": 1, "load_full_step": 1},
            "model": model_cfg,
            "training": {"num_iters": CT_ITERS, "num_epochs": 1,
                         "val_every": 1, "log_every": 50},
            "regularizers": tv_4000_defaults()}, f, sort_keys=False)
    t0 = time.perf_counter()
    system, state, done = cli.main(["--config", cfg_path, "--device",
                                    str(dev)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    model = system.model
    ds = system.train_dataset
    cams = np.unique(ds.all_coords[:, -2].astype(int))
    T = state.params["embedding"]["color_transform_0"]["transform"]
    learned = 1.0 + T.detach().cpu().numpy()[:, [0, 4, 8]]
    # relative to the rig's mean: what a per-camera transform can explain
    # (a gain common to every camera the scene's colours take)
    rel_want = gains[cams] / gains[cams].mean(0)
    rel_got = learned[cams] / learned[cams].mean(0)
    before = float(np.abs(1.0 - rel_want).mean())
    after = float(np.abs(rel_got - rel_want).mean())
    corr = float(np.corrcoef(rel_got.ravel(), rel_want.ravel())[0, 1])
    print(f"# 87. {card}: the flagship with a color_transform stage, "
          f"{state.it} CLI steps on a {len(cams)}-camera rig at {CT_WH} "
          f"with gains in {CT_GAIN} ({fit_s:.1f} s with the load; "
          f"{done['final']}); the learned diagonal gains relative to the "
          f"rig's mean: mean |error| {after:.4f} against {before:.4f} "
          f"untrained, correlation {corr:.3f}", flush=True)
    if not (after < before and corr > 0.5):
        raise AssertionError(f"the learned colour transforms did not move "
                             f"toward the cameras' gains: {after} vs "
                             f"{before}, correlation {corr}")
    # its own route against the general colour net on a held-out view
    mcfg = resolve_model_cfg(system.cfg, system.iters_per_epoch)
    rec, rview = own_route_view(
        torch, dev, card, reset_counts, read_counts, "color_transform",
        mcfg, ds.info(), model, state.params, state.it,
        system.val_dataset.image(0))
    records.append(rec)
    record["color_transform"] = {
        "fit_s": fit_s, "gain_error_before_after": [before, after],
        "gain_correlation": corr, "final": done["final"], **rview}
    del system, state, model
    torch.cuda.empty_cache()

    # ---- 88-89. the time heads (n3d) and MLP_Fea (the flagship)
    dyn = gaussian_blob_scene(**TRAIN_SCENE, device=dev)
    for tag, preset, net in (
            ("88. neural_3d_z_plane, DensityFourier + RGBtFourier",
             "neural_3d_z_plane", {"densityMode": "DensityFourier",
                                   "shadingMode": "RGBtFourier"}),
            ("89. technicolor_z_plane, MLP_Fea", "technicolor_z_plane",
             {"shadingMode": "MLP_Fea"})):
        cfg, model = family_model(torch, preset, dyn.info(), **net)
        if model.color_net.fused_eligible or model._cf_eval is not None:
            raise AssertionError(f"{tag}: the head took a fused route")
        _, state, rec = family_fit(torch, dev, model, dyn, HEAD_STEPS, tag)
        rays = torch.from_numpy(dyn.all_coords[:CHUNK]).to(dev)
        reset_counts()
        out = model.apply(state.params, rays, StepCtx(it=state.it))["rgb"]
        torch.cuda.synchronize()
        got = read_counts()
        ms = cuda_ms(torch, lambda: model.apply(
            state.params, rays, StepCtx(it=state.it)), 2)
        print(f"# {tag} ({card}): an eval chunk of {rays.shape[0]} rays "
              f"through the general chain {ms:.3f} ms, launches {got}",
              flush=True)
        if not (torch.isfinite(out).all() and out.min() >= 0
                and out.max() <= 1) or any(got.values()):
            raise AssertionError(f"{tag}: eval rgb not finite in [0, 1] "
                                 f"or a kernel launched: {got}")
        record[preset + " " + net["shadingMode"]] = dict(rec, eval_ms=ms)
        del model, state
        torch.cuda.empty_cache()
    del dyn

    # ---- 90. tensor_vm and tensor_cp through the static chain
    static = gaussian_blob_scene(**STATIC_TRAIN_SCENE, device=dev)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b in itertools.islice(
                   static.batch_iterator(B, seed=SEED + 5), 12)]
    for t, comps in (("tensor_vm", (8, 24)), ("tensor_cp", (96, 288))):
        tag = f"90. {t} ({comps[0]}, {comps[1]} components)"
        cfg, model = family_model(
            torch, "llff_z_plane", static.info(), type=t,
            n_lamb_sigma=comps[0], n_lamb_sh=comps[1],
            N_voxel_init=EXTRA_GRID ** 3, upsamp_list=[],
            update_AlphaMask_list=[])
        # no TV regularizer: it reads the split net's planes, which these
        # nets do not have (as in the JAX package)
        trainer = Trainer(model, copy.deepcopy(DEFAULT_TRAINING),
                          iters_per_epoch=4000, device=dev)
        state = trainer.init_state(torch.Generator().manual_seed(SEED))
        state, hist = trainer.fit(
            state, iter(batches * 2), 5,
            gen=torch.Generator(device=dev).manual_seed(SEED), log_every=1)
        rec = {"image_loss_first_last": [hist[0]["image_loss"],
                                         hist[-1]["image_loss"]]}
        net = model.color_net
        before = list(net.grid_size)
        ms0 = step_ms(torch, trainer, state, batches, reps=10)
        state.params["color"] = net.upsample(
            state.params["color"], [EXTRA_UPSAMPLE] * 3)
        # an upsample resets the optimizer (as Trainer.apply_event does)
        state.opt_state = trainer.make_optimizer(state.params).init(
            state.params)
        ms1 = step_ms(torch, trainer, state, batches, reps=10)
        print(f"# {tag} ({card}): grid {before} -> {net.grid_size}; the "
              f"step {ms0:.3f} ms, after the upsample {ms1:.3f} ms (CUDA "
              "events, 10 steps)", flush=True)
        if not params_finite(torch, state.params):
            raise AssertionError(f"{tag}: a param is not finite")
        record[t] = dict(rec, step_ms_init_upsampled=[ms0, ms1])
        del trainer, state, model
        torch.cuda.empty_cache()

    # ---- 91. the standalone net's own march
    cfg = presets.llff_z_plane()["color"]["net"]
    cfg = dict(cfg, type="tensor_vm_split", near_far=[0.5, 3.5],
               nSamples=128, N_voxel_init=EXTRA_GRID ** 3,
               aabb=[[-1.5] * 3, [1.5] * 3])
    net = build_color_net(cfg)
    params = net.init(torch.Generator().manual_seed(SEED), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rays_all = torch.as_tensor(static.all_coords, device=dev)
    rgb_all = torch.as_tensor(static.all_rgb, device=dev)

    def march_step(params, opt, opt_state, i):
        idx = torch.randint(0, rays_all.shape[0], (STANDALONE_RAYS,),
                            device=dev, generator=gen)
        leaves = {k: {kk: vv.detach().requires_grad_() for kk, vv in
                      v.items()} if isinstance(v, dict)
                  else v.detach().requires_grad_()
                  for k, v in params.items()}
        ctx = StepCtx(it=i, training=True, gen=gen)
        out = net.march(leaves, rays_all[idx], ctx)["rgb"]
        loss = ((out - rgb_all[idx]) ** 2).mean()
        paths = tree_leaves(leaves)
        grads = dict(zip([p for p, _ in paths], torch.autograd.grad(
            loss, [v for _, v in paths])))
        return opt.step(params, grads, opt_state), float(loss)

    def run(params, n):
        opt = build_optimizer(DEFAULT_TRAINING["optimizers"],
                              net.param_groups(params), 4000)
        opt_state = opt.init(params)
        opt_state, first = march_step(params, opt, opt_state, 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            opt_state, last = march_step(params, opt, opt_state, i + 1)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n, first, last

    ms0, l0, l1 = run(params, 10)
    params = net.upsample(params, [EXTRA_UPSAMPLE] * 3)
    ms1, _, l2 = run(params, 10)
    print(f"# 91. {card}: the standalone tensor_vm_split march "
          f"({STANDALONE_RAYS} rays x {net.n_samples} samples): the step "
          f"{ms0:.3f} ms, after the upsample to {net.grid_size} {ms1:.3f} "
          f"ms (CUDA events, 10 steps); loss {l0:.5f} -> {l1:.5f} -> "
          f"{l2:.5f}", flush=True)
    if not (params_finite(torch, params) and np.isfinite(l2)):
        raise AssertionError("the standalone march: not finite")
    record["tensor_vm_split"] = {"step_ms_init_upsampled": [ms0, ms1],
                                 "loss": [l0, l1, l2]}
    return records, record


# ---- phases 92-96: the prediction side of the long tail

# the layer activations of the JAX kernel's _SAFE_ACTS that K1 takes (its
# row_l2_norm is a vector kind and takes the general chain), with an
# ease_value and an interp_value over them, whose weights at IT are 0.5
LAYER_ACTS = {
    "leaky_relu": "leaky_relu", "identity": "identity", "relu": "relu",
    "abs": "abs", "zero": "zero", "sigmoid": "sigmoid", "tanh": "tanh",
    "softplus": "softplus",
    "identity_tanh": {"type": "identity_tanh", "fac": 1.0},
    "ease_value": {"type": "ease_value", "start_value": 0.1,
                   "wait_iters": IT // 2, "window_iters": IT,
                   "activation": "sigmoid"},
    "interp_value": {"type": "interp_value", "act1": "relu",
                     "act2": "tanh", "wait_iters": IT // 2,
                     "window_iters": IT}}
# f32 operations of one activation of a kind, counted from K1's source
# (csrc/pack_build.cuh act_leaf: the affine in and out, the kind's own);
# an interp_value or ease_value adds its blend
ACT_OPS = {"leaky_relu": 2, "identity": 1, "relu": 1, "abs": 1, "zero": 1,
           "sigmoid": 6, "tanh": 8, "softplus": 8, "identity_tanh": 10,
           "ease_value": 8, "interp_value": 13}
# the field activations, grouped several per chain (every elementwise
# kind, an ease_value and an interp_value, on the z, isect, sigma, flow,
# flow-stage, point-sigma, offset, offset-stage and colour slots); each
# group's outputs (the prediction net's fields) and stage activations
FIELD_GROUPS = {
    "A": ({"z_vals": {"type": "softplus", "shift": -1.0},
           "sigma": {"type": "gaussian", "sigma": 2.0},
           "point_sigma": {"type": "ease_value", "start_value": 1.0,
                           "wait_iters": IT // 2, "window_iters": IT,
                           "activation": "sigmoid"},
           "spatial_flow": {"type": "interp_value", "act1": "zero",
                            "act2": {"type": "identity", "fac": 0.25},
                            "wait_iters": IT // 2, "window_iters": IT},
           "point_offset": {"type": "identity_tanh", "fac": 0.25},
           "color_scale": "relu", "color_shift": "abs"},
          {"isect": {"type": "power", "power": 1.5},
           "po_stage": {"type": "leaky_relu", "a": 0.2},
           "flow_stage": "tanh"}),
    "B": ({"z_vals": "tanh", "point_sigma": "zero",
           "spatial_flow": {"type": "leaky_relu", "a": 0.1},
           "point_offset": {"type": "power", "power": 2.0},
           "color_scale": {"type": "gaussian", "sigma": 0.5},
           "color_shift": {"type": "softplus", "inner_fac": 2.0}},
          {"isect": {"type": "identity_tanh", "fac": 1.0},
           "po_stage": "relu", "flow_stage": "abs"})}
# the encoded widths of phase 94: the ray range's windowed PE and the time
# range's windowed PE without its identity columns
ENCODED = {48: (("two_plane", 4, 5), 2), 96: (("pluecker", 6, 7), 3)}
LT_ITERS = 300                 # the long-tail flagship's CLI steps
LT_FRAMES = 2
GENERAL_RAYS = 16384           # phase 96's eval chunk and step batch


def with_acts(cfg, outputs=None, stages=None, layer=None):
    """The flagship chain with the prediction net's layer activation, its
    outputs' activations and the intersect's, the point offset's and the
    flow's (stage keys isect, po_stage, flow_stage) replaced."""
    import copy

    cfg = copy.deepcopy(cfg)
    emb = cfg["embedding"]["embeddings"]
    pred = emb["ray_prediction_0"]
    if layer is not None:
        pred["net"]["layer_activation"] = layer
    for k, a in (outputs or {}).items():
        pred["outputs"][k]["activation"] = a
    stages = stages or {}
    if "isect" in stages:
        emb["ray_intersect_0"]["intersect"]["activation"] = stages["isect"]
    if "po_stage" in stages:
        emb["point_offset_0"]["activation"] = stages["po_stage"]
    if "flow_stage" in stages:
        emb["flow_0"]["spatial_flow_activation"] = stages["flow_stage"]
    return cfg


def with_encoding(cfg, ray, time_freqs):
    """The flagship chain with the ray range's param and windowed PE
    (fn, its channels, frequencies) and the time range's windowed PE of
    `time_freqs` frequencies without its identity columns: encoded width
    ch (2 n + 1) + 2 time_freqs."""
    import copy

    cfg = copy.deepcopy(cfg)
    fn, ch, n = ray
    pred = cfg["embedding"]["embeddings"]["ray_prediction_0"]
    pred["params"]["ray"]["param"] = {"n_dims": ch, "fn": fn}
    pred["params"]["ray"]["pe"] = {"type": "windowed", "n_freqs": n}
    pred["params"]["time"]["pe"] = {"type": "windowed",
                                    "n_freqs": time_freqs,
                                    "exclude_identity": True}
    return cfg


def k1_variant(torch, dev, card, tag, cfg, info, chunk, reset_counts,
               read_counts, act_ops=0):
    """One K1 branch at the flagship's width on a 262,144-ray chunk: the
    chain's model under the bf16 policy (weights from SEED) renders the
    chunk through model.apply on the quad route (K1 and K2 once, finite,
    in [0, 1]); K1 against its plain version (rows 0-3 within
    PACK_TOL_BF16, the colour rows by bf16_colour_gate), under the f32
    policy on F32_RAYS (PACK_TOL), timed beside its plain version, its
    bound (the MLP's bf16 products, the tail's f32 operations and
    `act_ops`, the activations' f32 operations). Returns (the kernel's
    record, the branch's record)."""
    import copy

    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        FAR_SENTINEL, pack_build, pack_build_plain, pack_error)

    model = build_model(copy.deepcopy(cfg), dataset_info=info,
                        compute_dtype=torch.bfloat16)
    cf = model._cf_eval
    if cf is None:
        raise AssertionError(f"{tag}: the chain took the general chain")
    params = model.init(torch.Generator().manual_seed(SEED), dev)
    ctx = StepCtx(it=IT)
    with torch.no_grad():
        prep = model.prepare_eval(params)
        reset_counts()
        rgb = model.apply(params, chunk, ctx, {"cf_prepared": prep,
                                               "uniform_time": True})["rgb"]
        torch.cuda.synchronize()
        counts = read_counts()
        if not (only(counts, pack_build=1, shade=1)
                and torch.isfinite(rgb).all() and rgb.min() >= 0
                and rgb.max() <= 1):
            raise AssertionError(f"{tag}: the chunk's launches {counts} or "
                                 "its rgb")
        tabs = prep["mlp"]
        x = cf.pred.net_input(chunk, ctx).float().contiguous()
        rp = cf.ray_pack(chunk)
        pack = pack_build(x, tabs, rp, cf.spec, IT)
        pack_p = pack_build_plain(x, tabs, rp, cf.spec, IT)
        err = pack_error(pack, pack_p)[0]
        rows = (pack - pack_p).abs().amax(1).tolist()
        # the colour rows, the MLP's outputs themselves, by the gate of a
        # trained model (bf16_colour_gate): a one-ulp flip of a hidden
        # bf16 value carries into them further through smooth layer
        # activations than through the leaky relu
        gate = bf16_colour_gate(torch, pack, pack_p, tag, FAR_SENTINEL)
        del pack_p
        m32 = build_model(copy.deepcopy(cfg), dataset_info=info)
        cf32 = m32._cf_eval
        t32 = cf32.prepare(params)["mlp"]
        x32, r32 = x[:F32_RAYS].contiguous(), rp[:F32_RAYS].contiguous()
        err32 = pack_error(pack_build(x32, t32, r32, cf32.spec, IT),
                           pack_build_plain(x32, t32, r32, cf32.spec,
                                            IT))[0]
        ms = cuda_ms(torch, lambda: pack_build(x, tabs, rp, cf.spec, IT),
                     20)
        plain_ms = cuda_ms(torch, lambda: pack_build_plain(
            x, tabs, rp, cf.spec, IT), 3)
    mlp_ops = 2 * CHUNK * sum(
        p["weight"].numel() for p in
        params["embedding"]["ray_prediction_0"]["net"].values())
    bnd = bound(nbytes(x, rp, pack) + sum(nbytes(l.w, l.b)
                                          for l in tabs.layers),
                [(mlp_ops, BF16_OPS_PER_S),
                 (pack.shape[1] * K1_TAIL_OPS + act_ops, F32_OPS_PER_S)])
    generic = cf.spec.generic(tabs, IT)
    print(f"# {tag} ({card}): {x.shape[1]} encoded columns, the "
          f"{'generic' if generic else 'default'} instantiation; K1 "
          f"{ms:.3f} ms a chunk (plain {plain_ms:.3f}, bound {bnd[0]:.4f} "
          f"{bnd[1]}); max |kernel - plain| bf16 {err:.3e} (rows 0-3 tol "
          f"{PACK_TOL_BF16}, the colour rows by bf16_colour_gate; per pack "
          "row "
          + " ".join(f"{e:.1e}" for e in rows) + f"), f32 on {F32_RAYS} "
          f"rays {err32:.3e} (tol "
          f"{PACK_TOL}); chunk acc mean {rgb.mean().item():.4f}",
          flush=True)
    if not (gate and err32 <= PACK_TOL):
        raise AssertionError(f"{tag}: K1 disagrees with its plain version: "
                             f"{err}, {err32}")
    name = "pack_build_" + re.sub(r"[^a-z0-9]+", "_", tag.lower()).strip("_")
    rec = entry(name, "pack_build.cuh",
                "hyperreel_tpu/ops/pallas/pack_build.py:137",
                counts["pack_build"], max(err, err32), ms, plain_ms, bnd)
    return rec, {"ms": ms, "plain_ms": plain_ms, "err_bf16": err,
                 "err_f32": err32, "generic": bool(generic),
                 "encoded": int(x.shape[1]), "bound_ms": bnd[0]}


def k1_branch_phases(torch, dev, card, frame, reset_counts, read_counts):
    """Phases 92-94: K1 on the flagship's first bench chunk at each layer
    activation (92), with the field activations of FIELD_GROUPS (93) and
    at 48 and 96 encoded columns (94), each against its plain version.
    Returns (the kernels' records, the record)."""
    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, technicolor_z_plane)

    base = convert_epochs_to_iters(technicolor_z_plane(), 4000)
    info = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
    chunk = frame[0]
    # the layer activation's values in a chunk: the five hidden layers of
    # 256 (the prediction net's last layer has none; its outputs' field
    # activations are in K1_TAIL_OPS)
    acts = CHUNK * 5 * 256
    records, record = [], {"layer": {}, "field": {}, "encoded": {}}
    for name, act in LAYER_ACTS.items():
        rec, r = k1_variant(
            torch, dev, card, f"92. layer activation {name}",
            with_acts(base, layer=act), info, chunk, reset_counts,
            read_counts, act_ops=acts * ACT_OPS[name])
        records.append(rec)
        record["layer"][name] = r
    # the field activations' operations are K1_TAIL_OPS' (the default
    # kinds' count: the bound stays a least time for the other kinds)
    for name, (outputs, stages) in FIELD_GROUPS.items():
        rec, r = k1_variant(
            torch, dev, card, f"93. field activations {name}",
            with_acts(base, outputs, stages), info, chunk, reset_counts,
            read_counts)
        records.append(rec)
        record["field"][name] = r
    for width, (ray, tf) in ENCODED.items():
        rec, r = k1_variant(
            torch, dev, card, f"94. {width} encoded columns",
            with_encoding(base, ray, tf), info, chunk, reset_counts,
            read_counts)
        if r["encoded"] != width:
            raise AssertionError(f"94. {r['encoded']} encoded columns, "
                                 f"not {width}")
        records.append(rec)
        record["encoded"][width] = r
    return records, record


def longtail_cfg():
    """The long-tail flagship: technicolor_z_plane's widths (6 x 256 MLP,
    skip at 3, 32 samples, 161^2 space plane) with the prediction stage's
    ray range pluecker with use_local_param and a 16-frequency
    windowed_random PE, the time range a 4-frequency random PE (47
    encoded columns), relu between the MLP's layers, identity_tanh on the
    point offset and an interp_value from zero to identity x 0.25 on the
    spatial flow (over the run's second hundred steps)."""
    from hyperreel_tpu_torch.configs.presets import technicolor_z_plane

    cfg = technicolor_z_plane()
    pred = cfg["embedding"]["embeddings"]["ray_prediction_0"]
    pred["params"]["ray"].update(
        param={"n_dims": 6, "fn": "pluecker", "use_local_param": True,
               "voxel_size": [1.0, 1.0, 1.0]},
        pe={"type": "windowed_random", "n_freqs": 16, "sigma": 1.0,
            "seed": SEED + 1, "wait_iters": 0,
            "max_freq_iter": LT_ITERS // 2})
    pred["params"]["time"]["pe"] = {"type": "random", "n_freqs": 4,
                                    "sigma": 1.0, "seed": SEED + 2}
    pred["net"]["layer_activation"] = "relu"
    pred["outputs"]["point_offset"]["activation"] = {
        "type": "identity_tanh", "fac": 0.25}
    pred["outputs"]["spatial_flow"]["activation"] = {
        "type": "interp_value", "act1": "zero",
        "act2": {"type": "identity", "fac": 0.25},
        "wait_iters": LT_ITERS // 3, "window_iters": LT_ITERS // 3}
    return cfg


def longtail_phase(torch, dev, card, reset_counts, read_counts, tmp):
    """Phase 95: the long-tail flagship trained LT_ITERS steps through the
    CLI (main.main) on a 4 x 4 rig written as phase 87 writes it (unit
    gains), then a held-out view through the Renderer on the quad route
    (K1 + K2, once per chunk) and on the fused patch route (K1 + K3) at
    R=4 (4, 3): its PSNR above the untrained model's on the same view, the
    patch route within PATH_TOL of the quad route where its witness
    passes; on the view's chunk K1 and K2 against their plain versions
    (trained_flagship_chunk), fused against the general chain under the
    f32 MLP policy (<= PATH_TOL, the rays with a sample on an aabb face
    left out). Returns (the kernels' records, the record)."""
    import copy

    import yaml

    from hyperreel_tpu_torch import main as cli
    from hyperreel_tpu_torch.config import resolve_model_cfg
    from hyperreel_tpu_torch.configs.presets import with_coherent_gather
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build
    from hyperreel_tpu_torch.train.metrics import psnr
    from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
    from hyperreel_tpu_torch.train.render import Renderer

    root = write_gained_scene(os.path.join(tmp, "longtail"),
                              np.ones((TECH_RIG * TECH_RIG, 3)),
                              LT_FRAMES)
    model_cfg = longtail_cfg()
    model_cfg["color"]["net"].update(upsamp_list=[],
                                     update_AlphaMask_list=[LT_ITERS // 2])
    cfg_path = os.path.join(tmp, "longtail.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "params": {"seed": SEED, "save_dir": os.path.join(tmp, "runs"),
                       "name": "longtail", "compute_dtype": "bfloat16"},
            "dataset": {"name": "technicolor", "root_dir": root,
                        "img_wh": list(CT_WH), "num_frames": LT_FRAMES,
                        "keyframe_step": 1, "load_full_step": 1},
            "model": model_cfg,
            "training": {"num_iters": LT_ITERS, "num_epochs": 1,
                         "val_every": 1, "log_every": 50},
            "regularizers": tv_4000_defaults()}, f, sort_keys=False)
    t0 = time.perf_counter()
    system, state, done = cli.main(["--config", cfg_path, "--device",
                                    str(dev)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    model, ds = system.model, system.train_dataset
    mcfg = resolve_model_cfg(system.cfg, system.iters_per_epoch)
    info = ds.info()
    cf = model._cf_eval
    if cf is None or not cf.spec.generic(
            model.prepare_eval(state.params)["mlp"], state.it):
        raise AssertionError("95. the long-tail flagship did not take K1's "
                             "generic instantiation")
    view = system.val_dataset.image(0)
    W, H = system.val_dataset.img_wh
    gt = torch.from_numpy(view["rgb"].reshape(H, W, 3))
    renderer = Renderer(model, ray_chunk=CHUNK, device=dev)
    reset_counts()
    out = renderer.render_rays(state.params, view["rays"], it=state.it)
    counts = read_counts()
    rgb = torch.from_numpy(np.clip(out["rgb"], 0, 1))
    n_chunks = -(-view["rays"].shape[0] // CHUNK)
    view_ms = cuda_ms(torch, lambda: renderer.render_rays(
        state.params, view["rays"], it=state.it), 3)
    p_trained = psnr(rgb.reshape(H, W, 3), gt).item()
    init = model.init(torch.Generator().manual_seed(SEED), dev)
    p_init = psnr(torch.from_numpy(np.clip(renderer.render_rays(
        init, view["rays"], it=state.it)["rgb"], 0, 1)).reshape(H, W, 3),
        gt).item()
    del init
    # the fused patch route on a clone of the trained model
    pm = build_model(with_coherent_gather(mcfg, *PATCH_R4),
                     dataset_info=info, compute_dtype=torch.bfloat16)
    pm.color_net.aabb = model.color_net.aabb
    pm.color_net.grid_size = list(model.color_net.grid_size)
    reset_counts()
    pout = Renderer(pm, ray_chunk=CHUNK, device=dev).render_rays(
        state.params, view["rays"], it=state.it)
    pcounts = read_counts()
    viol = float(np.max(pout["patch_coverage_viol"]))
    patch_err = float(np.abs(pout["rgb"] - out["rgb"]).max())
    print(f"# 95. {card}: the long-tail flagship, {state.it} CLI steps "
          f"({fit_s:.1f} s with the load; {done['final']}); a held-out "
          f"view ({W} x {H}) through the Renderer: quad route {view_ms:.3f} "
          f"ms, psnr {p_trained:.3f} dB (untrained {p_init:.3f}), launches "
          f"{counts}; fused patch route R=4 (4, 3): witness {viol:.2e}, "
          f"max |rgb - quad| {patch_err:.3e}, launches {pcounts}",
          flush=True)
    if not (only(counts, pack_build=n_chunks, shade=n_chunks)
            and only(pcounts, pack_build=n_chunks, shade_patch=n_chunks)
            and p_trained > p_init
            and (viol > PVIOL_EXACT or patch_err <= PATH_TOL)):
        raise AssertionError("95. the long-tail flagship's view: launches, "
                             "PSNR or the patch route")
    # K1 and K2 on the view's chunk; fused against the general chain
    chunk = torch.from_numpy(view["rays"][:CHUNK]).to(dev)
    ctx = StepCtx(it=state.it)
    model32 = build_model(copy.deepcopy(mcfg), dataset_info=info)
    model32.color_net.aabb = model.color_net.aabb
    model32.color_net.grid_size = list(model.color_net.grid_size)
    with torch.no_grad():
        prep = model.prepare_eval(state.params)
        k1, k2 = trained_flagship_chunk(torch, model, state.params, chunk,
                                        ctx, prep, "long-tail flagship",
                                        model32)
        gcfg = copy.deepcopy(mcfg)
        gcfg["color"]["net"].update(fused_render_cf=False,
                                    fused_render=False)
        general = build_model(gcfg, dataset_info=info)
        general.color_net.aabb = model.color_net.aabb
        general.color_net.grid_size = list(model.color_net.grid_size)
        p16 = bf16_second_factors(torch, state.params)
        rays = chunk[:4096].contiguous()
        a = model32.apply(p16, rays, ctx)["rgb"]
        b = general.apply(p16, rays, ctx)["rgb"]
        fcf = model32._cf_eval
        fpack = pack_build(fcf.pred.net_input(rays, ctx).float().contiguous(),
                           fcf.prepare(p16)["mlp"], fcf.ray_pack(rays),
                           fcf.spec, ctx.it)
        near = near_face(torch, fpack, fcf.S)
        # every ray when every one has a sample on a face (phase 87)
        keep = ~near if not near.all() else torch.ones_like(near)
        path_err = (a - b).abs()[keep].max().item()
    print(f"# 95. fused vs general (f32 MLP), 4096 of the view's rays: max "
          f"|diff| {path_err:.3e} (tol {PATH_TOL}; {int((~keep).sum())} "
          f"rays with a sample on an aabb face left out, of "
          f"{int(near.sum())} that have one)", flush=True)
    if not path_err <= PATH_TOL:
        raise AssertionError(f"95. fused and general chains disagree: "
                             f"{path_err}")
    records = flagship_entries("longtail", counts, k1, k2)
    record = {"fit_s": fit_s, "final": done["final"], "view_ms": view_ms,
              "psnr": p_trained, "psnr_untrained": p_init,
              "patch_viol": viol, "patch_err": patch_err,
              "path_err": path_err, "launches": counts,
              "patch_launches": pcounts}
    del system, state, model, model32, general, pm, prep, p16
    torch.cuda.empty_cache()
    return records, record


def general_chain_phase(torch, dev, card, reset_counts, read_counts):
    """Phase 96: the modules that take the general chain. neural_3d_z_plane
    at full width (bf16) with an angular flow (the predicted field
    angular_flow, tanh rates and anchors) and two ray outputs: one
    GENERAL_RAYS eval chunk (no kernel launched by the chain) and one
    training step on the dynamic blob scene; then every ray param of the
    registry, one GENERAL_RAYS eval chunk each on llff_z_plane: as the
    model-level param where it keeps the six ray channels (the general
    chain, then the net's own route, K5), else as the prediction stage's
    ray range param (K1, K5). Returns the record."""
    import copy

    from hyperreel_tpu_torch.configs import presets
    from hyperreel_tpu_torch.data.synthetic import gaussian_blob_scene
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.models.ray_param import RAY_PARAMS

    record = {}
    dyn = gaussian_blob_scene(**TRAIN_SCENE, device=dev)
    cfg = presets.convert_epochs_to_iters(presets.neural_3d_z_plane(), 4000)
    emb = cfg["embedding"]["embeddings"]
    pred = emb["ray_prediction_0"]
    pred["outputs"]["angular_flow"] = {"channels": 6,
                                       "activation": "identity"}
    pred["ray_outputs"] = {"ray_scale": {"channels": 3,
                                         "activation": "sigmoid"},
                           "ray_shift": {"channels": 1,
                                         "activation": "tanh"}}
    emb["flow_0"].update(use_angular_flow=True,
                         angular_flow_rotation_activation={
                             "type": "tanh", "outer_fac": 0.5},
                         angular_flow_anchor_activation="tanh")
    model = build_model(copy.deepcopy(cfg), dataset_info=dyn.info(),
                        compute_dtype=torch.bfloat16)
    if model._cf_eval is not None:
        raise AssertionError("96. angular flow took the fused route")
    trainer, state, rec = family_fit(torch, dev, model, dyn, 1,
                                     "96. neural_3d_z_plane with angular "
                                     "flow and ray outputs")
    rays = torch.from_numpy(dyn.all_coords[:GENERAL_RAYS]).to(dev)
    ctx = StepCtx(it=state.it)
    with torch.no_grad():
        reset_counts()
        x = model.embedding.apply(state.params["embedding"],
                                  model.ray_param.apply(rays), ctx,
                                  {"fields": ["angular_flow_rot",
                                              "ray_scale", "ray_shift"]})
        out = model.apply(state.params, rays, ctx)["rgb"]
        torch.cuda.synchronize()
        got = read_counts()
        ms = cuda_ms(torch, lambda: model.apply(state.params, rays, ctx), 3)
    print(f"# 96. {card}: the eval chunk ({GENERAL_RAYS} rays) through the "
          f"general chain {ms:.3f} ms, launches {got}; ray outputs "
          f"{tuple(x['ray_scale'].shape)}, {tuple(x['ray_shift'].shape)}, "
          f"the rotation rates' mean |.| "
          f"{x['angular_flow_rot'].abs().mean().item():.4f}", flush=True)
    if not (torch.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
            and x["ray_scale"].shape == (GENERAL_RAYS, 3)
            and x["ray_shift"].shape == (GENERAL_RAYS, 1)
            and got["pack_build"] == 0):
        raise AssertionError("96. the angular-flow chain's eval")
    record["angular_flow"] = dict(rec, eval_ms=ms)
    del model, trainer, state, dyn
    torch.cuda.empty_cache()

    static = gaussian_blob_scene(**STATIC_TRAIN_SCENE, device=dev)
    rays = torch.from_numpy(static.all_coords[:GENERAL_RAYS]).to(dev)
    base = presets.convert_epochs_to_iters(presets.llff_z_plane(), 4000)
    params_cfg = {
        "identity": {}, "take": {"input_channels": [0, 1, 2, 3, 4, 5]},
        "position": {}, "two_plane": {"use_local_param": True},
        "multi_plane": {"z_channels": 4}, "two_plane_matrix": {
            "matrix": (np.eye(4) + 0.1).tolist()},
        "two_cylinder": {"near": 0.5, "far": 2.0},
        "ray_plus_time": {"param": {"fn": "two_plane"}},
        "voxel_center": {"voxel_size": 0.5}, "z_slice": {"z": 0.5},
        "contract_points": {"param": {"fn": "identity"},
                            "contract": {"type": "mipnerf"}},
        "pluecker": {"use_local_param": True}, "spherical": {"radius": 2.0},
        "xy": {}, "rays": {}, "pluecker_pos": {}}
    six = ("identity", "take", "voxel_center", "contract_points",
           "pluecker", "rays")
    for fn in RAY_PARAMS:
        c = copy.deepcopy(base)
        pc = dict(params_cfg[fn], fn=fn)
        if fn in six:
            c["param"] = dict(pc, n_dims=6)
        else:
            rr = c["embedding"]["embeddings"]["ray_prediction_0"]["params"]
            rr["ray"]["param"] = pc
            rr["ray"]["pe"] = None
        m = build_model(c, dataset_info=static.info(),
                        compute_dtype=torch.bfloat16)
        params = m.init(torch.Generator().manual_seed(SEED), dev)
        with torch.no_grad():
            rk = {"cf_prepared": m.prepare_eval(params)}
            reset_counts()
            o = m.apply(params, rays, StepCtx(it=IT), rk)["rgb"]
            torch.cuda.synchronize()
            got = read_counts()
        route = "K1" if m._cf_eval is not None else "general chain"
        print(f"# 96. ray param {fn} "
              f"({'model-level' if fn in six else 'prediction range'}): "
              f"{route}, launches {got}, rgb mean {o.mean().item():.4f}",
              flush=True)
        if not (torch.isfinite(o).all() and o.min() >= 0 and o.max() <= 1
                and (fn == "identity" or fn not in six) ==
                (m._cf_eval is not None)):
            raise AssertionError(f"96. ray param {fn}: rgb or route")
        record[f"ray_param {fn}"] = {"route": route, "launches": got}
        del m, params
    return record


def main():
    import torch

    # ---- 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; none is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    print(host_report(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels import build
    from hyperreel_tpu_torch.ops.kernels.composite import (
        composite, composite_plain)
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        pack_build, pack_build_plain)
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        PatchSpec, patch_blend, patch_blend_plain)
    from hyperreel_tpu_torch.ops.kernels.shade import (
        ShadeSpec, premix_time, shade, shade_plain, shade_preblended,
        shade_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_patch import (
        shade_patch, shade_patch_plain)

    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        shade_multi, shade_multi_preblended)
    from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
        shade_multi_patch)

    counted = (pack_build, shade, shade_preblended, shade_patch, patch_blend,
               composite, shade_multi, shade_multi_preblended,
               shade_multi_patch)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        return {fn.__name__: fn.launches for fn in counted}

    # ---- 2. build
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"# kernels built in {lib.build_seconds:.1f} s "
          f"(loaded after {time.perf_counter() - t0:.1f} s)", flush=True)
    # each kernel's registers and spills, under its name and its mangled
    # template arguments (Li2E: the int 2, Lb1E: true)
    source = ""
    for line in lib.compiler_log.splitlines():
        if line.startswith("== "):
            source = line[3:]
        elif "Compiling entry function" in line:
            m = re.search(r"\d([a-z_]+_kernel)(I.*?E)Ev", line)
            source = f"{m.group(1)}<{m.group(2)}>" if m else line.strip()
        elif "registers" in line or "spill" in line:
            print(f"# {source}: {line.strip()}")

    # ---- 3. the flagship, K1 and K2 against their plain versions
    cfg, info, model, params, prep = flagship(dev)
    ctx = StepCtx(it=IT)
    cf = model._cf_eval
    frame = torch.from_numpy(bench_frame()).to(dev)
    chunk = frame[0]

    net_in = cf.pred.net_input(chunk, ctx).float().contiguous()
    rp = cf.ray_pack(chunk)
    tabs = prep["mlp"]
    pack = pack_build(net_in, tabs, rp, cf.spec, IT)
    pack_p = pack_build_plain(net_in, tabs, rp, cf.spec, IT)
    torch.cuda.synchronize()
    k1_err = (pack - pack_p).abs().max().item()
    k1_rows = (pack - pack_p).abs().amax(1).tolist()
    print(f"# K1 pack_build (bf16 MLP) max |kernel - plain| = {k1_err:.3e} "
          f"(tol {PACK_TOL_BF16}); per row "
          + " ".join(f"{e:.1e}" for e in k1_rows), flush=True)
    if not k1_err <= PACK_TOL_BF16:
        raise AssertionError(f"K1 disagrees with its plain version: {k1_err}")
    # the same kernel under the f32 MLP policy, where nothing is rounded
    cf32 = build_model(cfg, dataset_info=info)._cf_eval
    tabs32 = cf32.prepare(params)["mlp"]
    x32, rp32 = net_in[:F32_RAYS].contiguous(), rp[:F32_RAYS].contiguous()
    k1_err32 = (pack_build(x32, tabs32, rp32, cf32.spec, IT)
                - pack_build_plain(x32, tabs32, rp32, cf32.spec, IT)
                ).abs().max().item()
    print(f"# K1 pack_build (f32 MLP, {F32_RAYS} rays) max |kernel - plain| "
          f"= {k1_err32:.3e} (tol {PACK_TOL})", flush=True)
    if not k1_err32 <= PACK_TOL:
        raise AssertionError(f"K1 (f32) disagrees with its plain version: "
                             f"{k1_err32}")
    k1_ms = cuda_ms(torch, lambda: pack_build(net_in, tabs, rp, cf.spec, IT),
                    20)
    k1_plain_ms = cuda_ms(
        torch, lambda: pack_build_plain(net_in, tabs, rp, cf.spec, IT), 3)

    H, W, TH, TW, C, nd = prep["dims"]
    k2_err = 0.0
    specs = {}
    for th in (TH, 0):               # per-sample time mix, frame premix
        ttab = prep["ttab"] if th else premix_time(prep["ttab"], rp[0, 7])
        spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=th, C=C, nd=nd,
                         deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale)
        specs[th] = (ttab, spec)
        out = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        out_p = shade_plain(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        print(f"# K2 shade TH={th}: max |kernel - plain| rgb/acc "
              f"{err:.3e}, depth {derr:.3e} (tol {SHADE_TOL}); "
              f"acc mean {out[:, 3].mean().item():.4f}", flush=True)
        if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL):
            raise AssertionError(f"K2 disagrees with its plain version "
                                 f"(TH={th}): {err}, {derr}")
        k2_err = max(k2_err, err)
    ttab, spec = specs[0]            # the frame route (uniform t)
    # the chunk's colour: both kernels against both plain versions (the
    # bf16 MLP's rounding flips of K1 included), at the fused-path gate
    out = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
    out_p = shade_plain(prep["quad"], pack_p, rp, ttab, prep["wb"], spec)
    chunk_err = (out[:, :4] - out_p[:, :4]).abs().max().item()
    print(f"# chunk rgb/acc, kernels vs plain versions: max |diff| "
          f"{chunk_err:.3e} (tol {PATH_TOL})", flush=True)
    if not chunk_err <= PATH_TOL:
        raise AssertionError(f"kernels and plain versions disagree on the "
                             f"chunk: {chunk_err}")
    k2_ms = cuda_ms(torch, lambda: shade(prep["quad"], pack, rp, ttab,
                                         prep["wb"], spec), 20)
    k2_plain_ms = cuda_ms(torch, lambda: shade_plain(
        prep["quad"], pack, rp, ttab, prep["wb"], spec), 3)
    print(f"# one {CHUNK}-ray chunk: K1 {k1_ms:.3f} ms "
          f"(plain {k1_plain_ms:.3f}), K2 TH=0 {k2_ms:.3f} ms "
          f"(plain {k2_plain_ms:.3f})", flush=True)
    N = pack.shape[1]
    valid = valid_count(pack)
    mlp_ops = 2 * CHUNK * sum(
        p["weight"].numel() for p in
        params["embedding"]["ray_prediction_0"]["net"].values())
    k1_bound = bound(
        nbytes(net_in, rp, pack) + sum(nbytes(l.w, l.b) for l in tabs.layers),
        [(mlp_ops, BF16_OPS_PER_S), (N * K1_TAIL_OPS, F32_OPS_PER_S)])
    k2_bound = sh_bound(
        "flagship K2", nbytes(pack, rp, ttab) + CHUNK * 5 * 4
        + rows_bytes(prep["quad"], quad_rows(pack, 0, 1, W, H)),
        lambda f: [(valid * (shade_ops(C, nd, fold=f) + 8 * C + 10)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    print(f"# chunk: {valid} of {N} samples valid; MLP {mlp_ops / 1e9:.1f} "
          f"GFLOP; bounds K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}), K2 "
          f"{k2_bound[0]:.4f} ms ({k2_bound[1]})", flush=True)
    k1_plan(torch, "flagship", cf, tabs, mlp_ops, k1_ms)
    del pack_p, out_p
    torch.cuda.empty_cache()

    # ---- 4. the bench frame through model.apply (quad route)
    rk = {"cf_prepared": prep, "uniform_time": True}

    def render(m, frames, rkw):
        return [m.apply(params, frames[i], ctx, rkw)
                for i in range(frames.shape[0])]

    n_chunks = frame.shape[0]
    reset_counts()
    outs = render(model, frame, rk)
    torch.cuda.synchronize()
    quad_counts = read_counts()
    rgb_quad = torch.cat([o["rgb"] for o in outs])
    viol = max(float(o["uniform_time_viol"]) for o in outs)
    print(f"# frame {SIDE}x{SIDE} (quad): rgb {tuple(rgb_quad.shape)} "
          f"min {rgb_quad.min().item():.4f} max {rgb_quad.max().item():.4f} "
          f"mean {rgb_quad.mean().item():.4f}; launches {quad_counts}; "
          f"uniform-time witness {viol}", flush=True)
    want = dict.fromkeys(quad_counts, 0)
    want.update(pack_build=n_chunks, shade=n_chunks)
    if quad_counts != want:
        raise AssertionError(f"kernel launches {quad_counts}, want {want}")
    if not (torch.isfinite(rgb_quad).all() and rgb_quad.min() >= 0
            and rgb_quad.max() <= 1 and rgb_quad.shape == (SIDE * SIDE, 3)):
        raise AssertionError("frame rgb is not finite in [0, 1]")
    if viol != 0.0:
        raise AssertionError(f"uniform-time witness {viol} != 0")

    # ---- 5. fused vs general path; the f32 MLP policy, where both
    # routes run the same MLP (under the bf16 policy the general path
    # stores every MLP layer in bf16, as the JAX general path does, where
    # the fused path keeps f32 sums)
    import copy
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"].update(fused_render_cf=False, fused_render=False)
    fused = build_model(cfg, dataset_info=info)
    general = build_model(cfg_g, dataset_info=info)
    rays = torch.from_numpy(entry_rays(4096)).to(dev)
    a = fused.apply(params, rays, ctx)["rgb"]
    b = general.apply(params, rays, ctx)["rgb"]
    path_err = (a - b).abs().max().item()
    print(f"# fused vs general, 4096 entry() rays: max |diff| "
          f"{path_err:.3e} (tol {PATH_TOL})", flush=True)
    if not path_err <= PATH_TOL:
        raise AssertionError(f"fused and general paths disagree: "
                             f"{path_err}")
    del fused, general, a, b
    torch.cuda.empty_cache()

    # ---- 6. the patch route's kernels and K7 against their plain versions
    model8, prep8 = patch_model(cfg, info, params, PATCH_R8)
    _, prep4 = patch_model(cfg, info, params, PATCH_R4)
    R8 = PATCH_R8[2]
    frame_pm = phase_major(frame, R8).contiguous()
    chunk_pm = frame_pm[0]
    rp_pm = cf.ray_pack(chunk_pm)
    pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                         .contiguous(), tabs, rp_pm, cf.spec, IT)

    def pspec(shape, pm):
        return PatchSpec(R=shape[2], px=shape[0], py=shape[1], W=W, H=H, C=C,
                         S=cf.S, phase_major=pm)

    ps8, ps4 = pspec(PATCH_R8, True), pspec(PATCH_R4, False)
    k3_err = 0.0
    for name, ptab, pk, rpk, ps in (
            ("R=8 (5,2), phase-major", prep8["patch"], pack_pm, rp_pm, ps8),
            ("R=4 (4,3), scanline", prep4["patch"], pack, rp, ps4)):
        out, vk = shade_patch(ptab, pk, rpk, ttab, prep["wb"], spec, ps)
        out_p, vp = shade_patch_plain(ptab, pk, rpk, ttab, prep["wb"], spec,
                                      ps)
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        print(f"# K3 shade_patch {name}: max |kernel - plain| rgb/acc "
              f"{err:.3e}, depth {derr:.3e} (tol {SHADE_TOL}); coverage "
              f"violations {int(vk)} (plain {int(vp)}) of "
              f"{N // ps.R} slots", flush=True)
        if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL
                and int(vk) == int(vp)):
            raise AssertionError(f"K3 disagrees with its plain version "
                                 f"({name}): {err}, {derr}, {int(vk)} vs "
                                 f"{int(vp)}")
        k3_err = max(k3_err, err)

    (feats,), _, k4_err = k4_check(torch, "flagship R=8 (5,2)",
                                   [prep8["patch"]], pack_pm, [ps8])
    (feats_p,), _ = patch_blend_plain([prep8["patch"]], pack_pm, [ps8])
    pre = shade_preblended(feats, pack_pm, rp_pm, ttab, prep["wb"], spec)
    pre_p = shade_preblended_plain(feats, pack_pm, rp_pm, ttab, prep["wb"],
                                   spec)
    chain_p = shade_preblended_plain(feats_p, pack_pm, rp_pm, ttab,
                                     prep["wb"], spec)
    torch.cuda.synchronize()
    pre_err = (pre[:, :4] - pre_p[:, :4]).abs().max().item()
    chain_err = (pre[:, :4] - chain_p[:, :4]).abs().max().item()
    print(f"# K2-preblended on K4's features: max |kernel - plain| "
          f"{pre_err:.3e} (tol {SHADE_TOL}); the chunk through K4 + "
          f"K2-preblended vs both plain versions {chain_err:.3e} (tol "
          f"{PATH_TOL})", flush=True)
    if not (pre_err <= SHADE_TOL and chain_err <= PATH_TOL):
        raise AssertionError(f"K2-preblended disagrees with its plain "
                             f"version: {pre_err}, {chain_err}")

    # the RGB colour of K2, K2-preblended and K3 on the same inputs (no
    # ported preset runs them: the dynamic single-axis net is SH), with a
    # random [3, C] basis, zero on the density channels
    gen = torch.Generator().manual_seed(SEED)
    wb_rgb = torch.cat([torch.zeros(3, nd), torch.randn(3, C - nd,
                                                        generator=gen)], 1)
    spec_rgb = dataclasses.replace(spec, shading="rgb")
    rgb_errs = {}
    for name, fn, fn_p, args in (
            ("K2", shade, shade_plain, (prep["quad"], pack, rp)),
            ("K2-preblended", shade_preblended, shade_preblended_plain,
             (feats, pack_pm, rp_pm))):
        o = fn(*args, ttab, wb_rgb, spec_rgb)
        o_p = fn_p(*args, ttab, wb_rgb, spec_rgb)
        torch.cuda.synchronize()
        rgb_errs[name] = (o[:, :4] - o_p[:, :4]).abs().max().item()
    o, vk = shade_patch(prep8["patch"], pack_pm, rp_pm, ttab, wb_rgb,
                        spec_rgb, ps8)
    o_p, vp = shade_patch_plain(prep8["patch"], pack_pm, rp_pm, ttab, wb_rgb,
                                spec_rgb, ps8)
    torch.cuda.synchronize()
    rgb_errs["K3 R=8 (5,2)"] = (o[:, :4] - o_p[:, :4]).abs().max().item()
    print("# RGB colour on the flagship's chunk, max |kernel - plain| "
          "rgb/acc: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                  rgb_errs.items())
          + f" (tol {SHADE_TOL}); K3 violations {int(vk)} (plain "
          f"{int(vp)})", flush=True)
    if not (max(rgb_errs.values()) <= SHADE_TOL and int(vk) == int(vp)):
        raise AssertionError(f"the RGB colour of K2 / K2-preblended / K3 "
                             f"disagrees with the plain versions: {rgb_errs}")
    del o, o_p

    # the patch kernels and K2 on the same chunk, timed in turns
    # (K2, K3, K4, K2-pre, K2-pre, K4, K3, K2), 20 calls each time
    kernels = {
        "K2": lambda: shade(prep["quad"], pack_pm, rp_pm, ttab, prep["wb"],
                            spec),
        "K3": lambda: shade_patch(prep8["patch"], pack_pm, rp_pm, ttab,
                                  prep["wb"], spec, ps8),
        "K4": lambda: patch_blend([prep8["patch"]], pack_pm, [ps8]),
        "K2-pre": lambda: shade_preblended(feats, pack_pm, rp_pm, ttab,
                                           prep["wb"], spec)}
    turns = {name: [] for name in kernels}
    for name in list(kernels) + list(kernels)[::-1]:
        turns[name].append(cuda_ms(torch, kernels[name], 20))
    print("# one chunk, in turns: " + "; ".join(
        f"{name} " + ", ".join(f"{t:.4f}" for t in ts) + " ms"
        for name, ts in turns.items()), flush=True)
    k3_ms, k4_ms, pre_ms = (sum(turns[n]) / 2 for n in ("K3", "K4",
                                                         "K2-pre"))
    k3_plain_ms = cuda_ms(torch, lambda: shade_patch_plain(
        prep8["patch"], pack_pm, rp_pm, ttab, prep["wb"], spec, ps8), 2)
    k4_plain_ms = cuda_ms(torch, lambda: patch_blend_plain(
        [prep8["patch"]], pack_pm, [ps8]), 2)
    pre_plain_ms = cuda_ms(torch, lambda: shade_preblended_plain(
        feats, pack_pm, rp_pm, ttab, prep["wb"], spec), 2)
    valid_pm = valid_count(pack_pm)
    out_bytes = CHUNK * 5 * 4
    k3_bound = sh_bound(
        "flagship K3", nbytes(pack_pm, rp_pm, ttab) + out_bytes + 4
        + rows_bytes(prep8["patch"], patch_rows(pack_pm, ps8, False)),
        lambda f: [(valid_pm * (shade_ops(C, nd, fold=f) + 8 * C + 22)
                    + N * COMPOSITE_OPS, F32_OPS_PER_S)], cf.S)
    k4_bound = bound(
        nbytes(pack_pm[:4], feats) + 4
        + rows_bytes(prep8["patch"], patch_rows(pack_pm, ps8, True)),
        [(N * (8 * C + 22), F32_OPS_PER_S)])
    pre_bound = sh_bound(
        "flagship K2-pre", nbytes(feats, pack_pm, rp_pm, ttab) + out_bytes,
        lambda f: [(valid_pm * shade_ops(C, nd, fold=f) + N * COMPOSITE_OPS,
                    F32_OPS_PER_S)], cf.S)
    print(f"# one chunk: K3 {k3_ms:.3f} ms (plain {k3_plain_ms:.3f}, bound "
          f"{k3_bound[0]:.4f} {k3_bound[1]}), K4 {k4_ms:.3f} ms (plain "
          f"{k4_plain_ms:.3f}, bound {k4_bound[0]:.4f} {k4_bound[1]}), "
          f"K2-preblended {pre_ms:.3f} ms (plain {pre_plain_ms:.3f}, bound "
          f"{pre_bound[0]:.4f} {pre_bound[1]})", flush=True)
    del feats_p, pre_p, chain_p, out_p, prep4
    torch.cuda.empty_cache()

    # K7 through its entry point, inputs from a seeded generator
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sig = 0.05 * torch.rand(CHUNK, COMPOSITE_S, device=dev, generator=gen)
    dst = torch.sort(0.1 + 2.9 * torch.rand(
        CHUNK, COMPOSITE_S, device=dev, generator=gen), -1).values
    col = torch.rand(CHUNK, COMPOSITE_S, 3, device=dev, generator=gen)
    sig[::2, -1] = 0.0     # the last delta is 1e10: half the rays end empty
    reset_counts()
    c_rgb, c_acc = composite(sig, dst, col, cf.net.distance_scale)
    torch.cuda.synchronize()
    k7_launches = read_counts()["composite"]
    p_rgb, p_acc = composite_plain(sig, dst, col, cf.net.distance_scale)
    k7_err = max((c_rgb - p_rgb).abs().max().item(),
                 (c_acc - p_acc).abs().max().item())
    k7_ms = cuda_ms(torch, lambda: composite(sig, dst, col,
                                             cf.net.distance_scale), 20)
    k7_plain_ms = cuda_ms(torch, lambda: composite_plain(
        sig, dst, col, cf.net.distance_scale), 3)
    k7_bound = bound(nbytes(sig, dst, col) + CHUNK * 4 * 4,
                     [(sig.numel() * COMPOSITE4_OPS, F32_OPS_PER_S)])
    print(f"# K7 composite B={CHUNK} S={COMPOSITE_S}: launches "
          f"{k7_launches}, max |kernel - plain| {k7_err:.3e} (tol "
          f"{COMPOSITE_TOL}), acc mean {c_acc.mean().item():.4f}; "
          f"{k7_ms:.4f} ms (plain {k7_plain_ms:.3f}, bound "
          f"{k7_bound[0]:.4f} {k7_bound[1]})", flush=True)
    if k7_launches != 1 or not k7_err <= COMPOSITE_TOL:
        raise AssertionError(f"K7: launches {k7_launches}, error {k7_err}")
    del sig, dst, col, p_rgb, p_acc

    # ---- 7. the bench frame on the patch route
    rk8 = {"cf_prepared": prep8, "uniform_time": True}
    route_counts = {}
    for route, fused_env, kernels in (
            ("fused patch", "1", {"shade_patch": n_chunks}),
            ("two-kernel patch", "0", {"patch_blend": n_chunks,
                                       "shade_preblended": n_chunks})):
        for order, frames in (("phase-major", frame_pm),
                              ("scanline", frame)):
            pm = order == "phase-major"
            with EnvVar("HYPERREEL_FUSED_PATCH", fused_env):
                reset_counts()
                outs = render(model8, frames, {**rk8,
                                               "rays_phase_major": pm})
                torch.cuda.synchronize()
                got = read_counts()
            want = dict.fromkeys(got, 0)
            want.update(pack_build=n_chunks, **kernels)
            if pm:
                route_counts[route] = got
            rgb = torch.cat([scanline(o["rgb"], R8) if pm else o["rgb"]
                             for o in outs])
            pviol = max(float(o["patch_coverage_viol"]) for o in outs)
            err = (rgb - rgb_quad).abs().max().item()
            print(f"# frame ({route}, {order} rays): launches {got}; "
                  f"coverage witness {pviol:.3e} (gate {PVIOL_EXACT}); rgb "
                  f"vs the quad route's frame {err:.3e} (tol {PATH_TOL})",
                  flush=True)
            if got != want:
                raise AssertionError(f"kernel launches {got}, want {want}")
            if not (pviol <= PVIOL_EXACT and err <= PATH_TOL):
                raise AssertionError(f"patch route ({route}, {order}): "
                                     f"witness {pviol}, rgb error {err}")

    # ---- 8. frame time of the three routes, in turns
    rk_pm = {**rk8, "rays_phase_major": True}
    routes = {"quad": ("1", model, frame, rk),
              "fused patch": ("1", model8, frame_pm, rk_pm),
              "two-kernel patch": ("0", model8, frame_pm, rk_pm)}
    times = {name: [] for name in routes}
    for name in (list(routes) + list(routes)[::-1]) * 2:
        env, m, frames, rkw = routes[name]
        with EnvVar("HYPERREEL_FUSED_PATCH", env):
            times[name].append(cuda_ms(
                torch, lambda: render(m, frames, rkw), TIMED_FRAMES))
    frame_ms = {}
    for name, ts in times.items():
        frame_ms[name] = sum(ts) / len(ts)
        print(f"# {card.splitlines()[0]}: {name} route {frame_ms[name]:.3f} "
              f"ms/frame, {SIDE * SIDE / frame_ms[name] / 1e3:.3f} Mrays/s "
              f"({TIMED_FRAMES} frames after a warm-up frame, 4 times: "
              + ", ".join(f"{t:.3f}" for t in ts) + ")", flush=True)
    del pack, pack_pm, feats, pre, out, rgb_quad, frame_pm
    torch.cuda.empty_cache()

    # ---- 9-13. the static multi-axis family (llff_z_plane)
    gpu = card.splitlines()[0]
    llff_entries, llff_frame_ms = static_phases(
        torch, dev, gpu, frame, reset_counts, read_counts, "llff")
    frame_ms.update(llff_frame_ms)

    # ---- 14-18. the dynamic multi-axis family (neural_3d_z_plane)
    n3d_entries, n3d_frame_ms = n3d_phases(
        torch, dev, gpu, frame, reset_counts, read_counts)
    frame_ms.update(n3d_frame_ms)
    torch.cuda.empty_cache()

    # ---- 19-23. the static RGB family on the channels-first route
    # (shiny_z_plane)
    shiny_entries, shiny_frame_ms = static_phases(
        torch, dev, gpu, frame, reset_counts, read_counts, "shiny")
    frame_ms.update(shiny_frame_ms)
    torch.cuda.empty_cache()

    # ---- 24-28. the single-axis RGB net through its own fused route
    # (stanford_llff_z_plane)
    stanford_entries, stanford_frame_ms = stanford_phases(
        torch, dev, gpu, frame, reset_counts, read_counts)
    frame_ms.update(stanford_frame_ms)
    torch.cuda.empty_cache()

    # ---- 29-40. the non-planar primitive presets through their colour
    # nets' own fused routes
    primitive_entries = []
    for family in ("catacaustics", "immersive", "donerf"):
        recs, fms = primitive_phases(torch, dev, gpu, reset_counts,
                                     read_counts, family)
        primitive_entries += recs
        frame_ms.update(fms)
        torch.cuda.empty_cache()

    # ---- 41-43. the flagship through the dynamic net's single-axis own
    # route
    own_entries, own_frame_ms = flagship_own_phase(
        torch, dev, gpu, cfg, info, params, frame, reset_counts, read_counts)
    frame_ms.update(own_frame_ms)
    torch.cuda.empty_cache()

    # ---- 44-53. the render-time sample counts (compaction, the stride)
    count_entries, base = [], None
    for family, stage, k in SAMPLE_COUNTS:
        if base is None or base[0] != family:
            base = None
            torch.cuda.empty_cache()
            if family == "flagship":
                base = (family, (cfg, info, params))
            elif family == "n3d":
                c, _, p, _ = n3d(dev)
                base = (family, (c, n3d_info(), p))
            else:
                c, _, p, _ = static_model(dev, family)
                base = (family, (c, None, p))
        recs, fms = sample_count_phases(
            torch, dev, gpu, frame, reset_counts, read_counts, family, stage,
            k, base[1])
        count_entries += recs
        frame_ms.update(fms)
    del base
    torch.cuda.empty_cache()

    # ---- 54-57. the flagship's training step, its grid events, the
    # trained model through K1 and K2, and a resumed checkpoint
    train_entries, train_record = training_phases(
        torch, dev, gpu, frame, reset_counts, read_counts)
    torch.cuda.empty_cache()

    # ---- 58-63. the multi-axis nets' training (llff_z_plane,
    # shiny_z_plane, neural_3d_z_plane), their trained models through K1,
    # K5, K6 and K4 + K5-pre, and a resumed llff checkpoint
    multi_train_entries, multi_train_record = multi_training_phases(
        torch, dev, gpu, frame, reset_counts, read_counts)
    torch.cuda.empty_cache()

    # ---- 64-66. training from scenes on disk: the flagship from a
    # Technicolor scene through the ray store, llff_z_plane from an LLFF
    # scene, their held-out views through K1 + K2 and K1 + K5; the ray
    # store alone
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scenes_")
    try:
        data_entries, data_record, tech_root, llff_root = data_phases(
            torch, dev, gpu, reset_counts, read_counts, tmp)
        torch.cuda.empty_cache()

        # ---- 67-73. the entry points: the CLI on both scenes, the viewer
        # and its server
        cli_entries, cli_record = cli_phases(
            torch, dev, gpu, reset_counts, read_counts, tmp, tech_root,
            llff_root)
        torch.cuda.empty_cache()
        print(f"# phases 1-73 took {time.perf_counter() - t_start:.1f} s",
              flush=True)

        # ---- 74-76. data parallelism: System.fit over one NCCL rank, two
        # ranks over gloo against one process
        t_dp = time.perf_counter()
        dp_record = dp_phases(torch, dev, gpu, tmp)
        print(f"# phases 74-76 took {time.perf_counter() - t_dp:.1f} s",
              flush=True)

        # ---- 77-83. the cascaded, voxel, reflect and deformable presets
        t_fam = time.perf_counter()
        family_entries, family_record = family_phases(
            torch, dev, gpu, reset_counts, read_counts, tmp, tech_root,
            llff_root)
        print(f"# phases 77-83 took {time.perf_counter() - t_fam:.1f} s",
              flush=True)

        # ---- 84-86. SH of degree 0-4: the six shade kernels on the
        # flagship's and llff's chunks, the SH-3 flagship's and SH-4
        # llff's frames on every route
        t_sh = time.perf_counter()
        sh_entries = sh_single_phase(torch, dev, gpu, frame, reset_counts,
                                     read_counts)
        sh_entries += sh_multi_phase(torch, dev, gpu, frame, reset_counts,
                                     read_counts)
        sh_frame_ms = sh_frame_phase(torch, dev, gpu, frame, reset_counts,
                                     read_counts, frame_ms)
        frame_ms.update(sh_frame_ms)
        print(f"# phases 84-86 took {time.perf_counter() - t_sh:.1f} s",
              flush=True)

        # ---- 87-91. the colour transform stage, the time heads, MLP_Fea,
        # tensor_vm, tensor_cp and the standalone net
        t_col = time.perf_counter()
        colour_entries, colour_record = colour_training_phases(
            torch, dev, gpu, reset_counts, read_counts, tmp)
        print(f"# phases 87-91 took {time.perf_counter() - t_col:.1f} s",
              flush=True)

        # ---- 92-96. the prediction side: K1 at every layer and field
        # activation and at wider encodings, the long-tail flagship, the
        # modules of the general chain
        t_lt = time.perf_counter()
        k1_entries, lt_record = k1_branch_phases(
            torch, dev, gpu, frame, reset_counts, read_counts)
        torch.cuda.empty_cache()
        lt_entries, lt_record["longtail"] = longtail_phase(
            torch, dev, gpu, reset_counts, read_counts, tmp)
        lt_record["general"] = general_chain_phase(
            torch, dev, gpu, reset_counts, read_counts)
        print(f"# phases 92-96 took {time.perf_counter() - t_lt:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("# SH bounds, ms with the basis folded per ray (the least work, "
          "the kernels' line) / by the unfolded count: " + "; ".join(
              f"{name} {new:.4f} / {old:.4f}"
              for name, (new, old) in SH_BOUNDS.items()), flush=True)
    print(f"# chip_smoke took {time.perf_counter() - t_start:.1f} s after "
          "the card check", flush=True)

    record = {"kernels": [
        entry("pack_build", "pack_build.cuh",
              "hyperreel_tpu/ops/pallas/pack_build.py:137",
              quad_counts["pack_build"], k1_err, k1_ms, k1_plain_ms,
              k1_bound),
        entry("shade", "shade.cu", "hyperreel_tpu/ops/pallas/shade.py:238",
              quad_counts["shade"], k2_err, k2_ms, k2_plain_ms, k2_bound),
        entry("shade_preblended", "shade.cu",
              "hyperreel_tpu/ops/pallas/shade.py:259",
              route_counts["two-kernel patch"]["shade_preblended"], pre_err,
              pre_ms, pre_plain_ms, pre_bound),
        entry("shade_patch", "shade_patch.cuh",
              "hyperreel_tpu/ops/pallas/shade.py:282",
              route_counts["fused patch"]["shade_patch"], k3_err, k3_ms,
              k3_plain_ms, k3_bound),
        entry("patch_blend", "patch_blend.cu",
              "hyperreel_tpu/ops/pallas/patch_blend.py:51",
              route_counts["two-kernel patch"]["patch_blend"], k4_err, k4_ms,
              k4_plain_ms, k4_bound),
        entry("composite", "composite.cu",
              "hyperreel_tpu/ops/pallas/composite.py:26", k7_launches,
              k7_err, k7_ms, k7_plain_ms, k7_bound)] + llff_entries
        + n3d_entries + shiny_entries + stanford_entries
        + primitive_entries + own_entries + count_entries + train_entries
        + multi_train_entries + data_entries + cli_entries
        + family_entries + sh_entries + colour_entries + k1_entries
        + lt_entries,
        "frame_ms": frame_ms, "train": train_record,
        "train_multi": multi_train_record, "data": data_record,
        "cli": cli_record, "data_parallel": dp_record,
        "families": family_record, "colour": colour_record,
        "prediction": lt_record}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2], sys.argv[3], *map(int, sys.argv[4:7]))
    elif sys.argv[1:2] == ["--nccl-probe"]:
        nccl_probe(*map(int, sys.argv[2:5]))
    else:
        main()
