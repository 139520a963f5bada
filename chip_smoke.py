#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device and ``nvcc`` (found through ``CUDA_HOME`` or ``PATH``);
it imports no JAX. Phases, each reported on its own line:

1. device: the card's name, power limit and maximum SM clock (from
   ``nvidia-smi``), its SM count, the torch and CUDA versions; no CUDA
   device is a failure, never a CPU run;
2. build: compiles every library of ``ops/_build.LIBRARIES``
   (``libwave_tpu_torch/csrc/segmm_g_a.cu``, ``segmm_seg.cu``,
   ``schur_matvec.cu``, ``schur_pcg.cu``, ``schur_precond.cu`` and
   ``hamming.cu``) for sm_90a,
   one nvcc each, started together, and loads them;
3. kernel: the G/A kernel through its window entry point
   (``dense_g_a_window``: the full W, the landmark-sorted layout and Hinv,
   window bounds) at each band call of the headline problem's first
   linearization, against its plain version and against the plain G/A of
   the call's slices of W, ids and Hinv (the operands the build cut before),
   after checking that every slot the layout leaves out holds W exactly 0;
   then the reference-signature ``dense_g_a`` and the window entry on
   ``bench_problem.g_a_edge_cases`` (duplicate ids within a pose, ids -1
   and >= M, a run spanning 40 poses cut by the pose window, one-pose
   windows, empty runs, M = 77 with c1 - c0 not a multiple of 4): within
   1e-6 * max|plain| (both sum the same f32 terms, only the order may
   differ) and bit for bit at every cell with at most one nonzero slot; then
   both timed at the headline's 13 calls. Every kernel time here
   is device time: CUDA events around the replay of a CUDA graph of many
   calls (``bench_problem.device_ms``), apart from the plain segment
   reduce and the plain G/A, which read their longest run (largest id
   multiplicity) on the host and are timed on a synchronized host clock
   (``bench_problem.wall_ms``);
4. headline: ``solve_ba`` on the full headline problem (200 poses, 10,000
   landmarks, 300 observations per pose, f32, bands) with the benchmark's
   configuration. It must take the explicit-S path with exactly 13 G/A
   launches, 3 segment reduces and 1 segment broadcast per LM iteration,
   run with TF32 off and without a synchronizing
   CUDA call that PyTorch's sync debug mode detects, give finite costs that
   end below the initial cost, and follow the trajectory of the same solve
   with the plain G/A forced on the card (rtol 1e-3). Then LM
   iterations/s for both, and a small f64 problem solved on the card
   against the CPU;
5. seg: the segment reduce and broadcast kernels against their plain
   versions at the headline's shapes (C = 3 and 6, K = 60,000, M = 10,000),
   the matrix-free profile's K = 480,000 and ``ba_large``'s problem
   (K = 600,000, M = 100,000, ids ordered by bearing), and on edge cases
   (ids < 0 and >= M, empty segments, C = 1 and 5, unaligned K, runs of
   ~120 slots at C = 6 in f64; for the broadcast
   ``bench_problem.broadcast_edge_cases``: K = 1, 3, 4,096, 4,097, C = 1,
   3, 5, 6, M = 300 and 22,000 (y past 384 KB), ids with storage offset 0
   and 1, f32 and f64):
   both bit for bit, the reduce bit-identical across two runs; then the
   kernel, the plain version and the one PyTorch call that computes the
   same function (``index_add_`` into zeros; ``index_select`` on y padded
   with a zero column), each timed as device time;
6. matrix_free: the 10-iteration headline solve with
   ``explicit_s="never"`` (matrix-free PCG): exactly 23 reduces, 1
   broadcast (schur_rhs's) and 1 launch of the preconditioner's self-blocks
   kernel per LM iteration (3 + 20 CG steps; every preconditioner through
   the kernel: ``schur.precond_fused`` over the LM iterations) and 20
   launches of each matvec kernel (W^T x, the
   Hll^-1 step, the pose side: each CG step's matvec is those and a
   reduce), every matvec on that fused path (the ``schur.matvec_fused``
   counter over ``schur.cg_trips``) and every CG trip through the trip
   kernel (``schur.cg_fused`` over ``schur.cg_trips``, one ``pcg_trip``
   call a trip), no G/A launch, no synchronizing call (and ``pcg`` at the
   first linearization under sync debug mode "error"),
   the first iteration within rtol 1e-3 of the same solve through the
   plain crossings, the final cost finite and below the initial; LM
   iterations/s through the kernels and through the plain crossings in
   alternating turns; each matvec kernel's device ms at the headline's
   first linearization beside its bound and its plain version's
   (``bench_problem.matvec_kernel_times``), and the fused and plain f32
   matvecs' distance from an f64 one (the fused within 2x the plain's or
   2^-24: ``bench_problem.matvec_error``); the three matvec kernels at
   venice-mf's whole shape on random operands (``bench_problem.
   MATVEC_CELL``: strided W, ids outside [0, M), fixed cameras; the pose
   side's 1,024-thread blocks) held to their plain versions (wt_slots and
   landmark_step bit for bit, pose_side within 1e-5 of its terms'
   magnitudes, two runs bit-identical) and timed beside their bounds; the
   CG trip kernel at venice-mf's and final-13682-mf's pose counts (1,778
   and 13,682, D = 6 and 15; ``bench_problem.PCG_TRIP_CASES``) held to its
   plain version (within 1e-5 of each output's magnitude, a frozen trip
   bit for bit, two runs bit-identical) and timed at D = 6 beside its
   bound and the eager loop body's time; the preconditioner's self-blocks
   kernel on venice-mf's whole shape (random operands, strided W) and on a
   sequential capture's ids at final-13682-mf's shape (``bench_problem.
   FINAL_CELL``) held to its plain version (within 1e-5 of its terms'
   magnitudes, both triangles equal, two runs bit-identical) and timed
   beside its bound and the plain composition it replaced; the headline
   solve from six seeds through the fused matvec, self-blocks and trip,
   the plain matvec and self-blocks, the plain CG loop and the CPU in f32, each held to the CPU's f64 solve (the
   fused solve's and the plain CG loop's median distances each within 2x
   the larger of the plain matvec's and the CPU f32 solve's); and
   ``bench_problem.matvec_profile`` (matvec ms at 300 to 2,400 observations
   per pose, the fit, the split by op);
7. ba_dataset: ``tests/test_ba.py``'s dataset (100 landmarks from
   ``draw_landmarks`` seed 7, 300 steps, fx = fy = 200, 10 Hz: 27 camera
   frames) generated on the card, written by ``save_vo_dataset`` into a
   temporary directory and read back by ``load_vo_dataset`` (the same
   problem arrays), built into BA problems by ``ba_from_dataset`` and
   solved at f64 through explicit S: 1 G/A, 3 reduce and 1 broadcast per
   LM iteration, no synchronizing call outside ``torch.linalg``; the
   perturb-and-recover case (25 iterations) under ``ba_test.cpp``'s bounds
   (0.01 rad, 0.1 m, observed landmarks 1 m) and the noisy offline case
   (1.1 px noise from a CPU generator, priors, 30 iterations) under
   ``gtsam_offline_example.cpp``'s as ``tests/test_ba.py`` holds them
   (0.1 m, 0.05 rad, landmark error mean 1.5 m and 85th percentile 2 m)
   on this draw (seed 0): they hold for some draws only
   (``tests/ba_noise_draws.py``), so what holds the card is the check
   beside them, each case against the same solve on this machine's CPU
   (cameras within 1 mm; the noisy case's final cost within rtol 1e-4);
   each solve then again with every G/A, reduce and broadcast call held
   to its plain version on the same inputs;
8. ba_batched: ``bench.py``'s batched windows (32 of 50 poses, 2,000
   landmarks, 240 observations per pose, seeds 10 + i, f32) through
   ``solve_ba_batched``: B = 8 and 32 dense and 32 PCG (explicit S with
   each window's band plan), launches per LM iteration as the code works
   them out (dense: one G/A per window; 3 reduces and 1 broadcast per
   iteration whatever B), no synchronizing call outside ``torch.linalg``,
   every window's accept flags equal to its own ``solve_ba``'s on the card
   and its costs within rtol 1e-5 (how many bit for bit is printed), then
   every G/A, reduce and broadcast call of each batched solve held to its
   plain version on the same inputs; ``bench.py``'s rates (one window PCG
   and dense, B = 8 and 32 dense and their speedups, B = 32 PCG);
9. ba_large: ``bench.py``'s ``ba_large`` (400 poses, 100,000 landmarks,
   1,500 observations per pose, 5 LM iterations) solved end to end through
   explicit S with its band plan: the band calls' G/A, 3 reduce and 1
   broadcast launches per iteration, no synchronizing call outside
   ``torch.linalg``, finite costs ending below the initial, the first
   iteration within rtol 1e-3 of the plain-G/A solve, the solve again with
   every G/A, reduce and broadcast call held to its plain version; LM
   iterations/s, peak allocation, and one iteration's G/A calls timed with
   their bound;
10. vio: ``bench.py``'s ``bench_vio`` configuration (BASELINE config 4:
   120 landmarks, 600 steps, 10 Hz keyframes, 15 LM iterations, 60 CG steps,
   f32) built by the port from seeds, solved with ``solver="auto"`` (the
   dense path, one G/A launch per iteration) and ``solver="pcg"`` (the
   fused matvec, as in matrix_free): launch counts as worked out from the
   code, the synchronizing calls listed (only
   ``torch.linalg`` calls allowed), final cost and ATE below the initial
   perturbation's, keyframes/s, and the same solve on this machine's CPU
   through the plain versions (final cost within rtol 1e-2, keyframe
   positions within 1 cm: at f32 the stiff IMU information drowns the
   vision terms' last digits, and the port's own f32 and f64 solves on the
   CPU end about 1 mm apart in ATE);
11. euroc: ``bench.py``'s ``euroc`` configuration (an MH_01-like ASL
   sequence of 16 s, 200 landmarks, seed 3, written by the port's
   ``generate_euroc_sequence`` into a temporary directory;
   ``EurocVIOParams()`` and ``default_vio_config``: 25 LM iterations, the
   dense solver, f32) built and solved by the port on the card: 1 G/A, 3
   reduce and 1 broadcast launches per LM iteration, no synchronizing call
   inside ``solve_vio`` outside ``optim/schur.py``'s ``torch.linalg``
   lines, a finite final cost below the initial, ATE below the dead-reckoned
   start's and under 0.03 m (the JAX package's own bound,
   ``tests/test_euroc_vio.py``), and the same build and solve on this
   machine's CPU through the plain versions (final cost within rtol 1e-4,
   keyframe positions within 1 mm: a quarter of the ATE; the two solves
   have parted by 5.5e-6 in cost and 1.6e-4 m); keyframes, landmarks, ATE,
   RPE, build seconds and solve keyframes/s;
12. windowed: ``bench.py``'s ``euroc_long`` in full (130 s at 5 Hz, 600
   landmarks, seed 0: 651 keyframes; the sequence written with a CPU
   ``torch.Generator``, so a machine without a card writes the same
   directory: its sha256 must equal the one taken where the JAX package's
   ATE was read) through ``run_euroc_vio_windowed`` on the card, f32:
   ``WindowedVIOParams(window=80, overlap=10, passes=2)`` and the freeze
   ablation. Launches as worked out from the code (1 G/A, 3 reduces, 1
   broadcast per LM iteration; 1, 2, 1 per device Schur complement), no
   synchronizing call made inside a solver entry point outside
   ``optim/schur.py``'s ``torch.linalg`` lines (the host loop's, such as
   each window's transfers and the chunk's cost read, are listed), finite
   window costs, no complement falling back to the host, the 2-pass ATE
   below the freeze ablation's and under 0.05 m (the JAX package's bound,
   ``tests/test_windowed_vio.py``; its ATE on the same directory is
   printed beside), and the first 2 windows against the same
   on this machine's CPU (window costs within rtol 1e-4, positions within
   1 mm); solve and sequence keyframes/s, marginalization seconds;
13. mh01_scale: ``bench.py``'s ``euroc_mh01_scale`` at its widths (20 Hz
   camera, 200 Hz IMU, 900 landmarks, ``window=120, overlap=12``, one
   pass), its 182 s cut to 36 s (721 keyframes, 7 windows; sha256 checked
   as in windowed): the stiffness gate must widen the Hessian to f64
   (f32 state, f64 pose-block sums, Cholesky and carried prior), launches
   and syncs as in windowed, no host fallback, ATE within 1.5x + 1 mm of
   the JAX package's on the same directory, and the first 2 windows
   against the same widened path on this machine's CPU (window costs
   within rtol 1e-4, positions within 1 mm);
14. windowed_ba: the JAX package's windowed-BA test circle
   (``bench_problem.windowed_ba_circle``: 181 frames, 120 landmarks, noisy
   odometry and priors, numpy seeds) through ``solve_ba_windowed`` on the
   card, f32, ``window=60, overlap=10``, 40 LM iterations a window
   (explicit-S PCG): launches and syncs as worked out from the code,
   position error under 0.1 m and rotation error under 0.05 rad (the
   reference's bounds), and its first 2 windows against the CPU's with
   explicit S (costs within rtol 1e-4, positions within 1 mm);
15. icp: ``bench.py``'s icp configuration (``bench_lidar.scan_pair``: 4,096
   points, turned 0.02 rad and moved (0.3, -0.15, 0.02) m; sha256 checked
   against the arrays ``tests/lidar_anchors.py`` fed the JAX package) on
   the card, f32: multiscale ICP (``ICPParams(max_iter=25,
   multiscale_steps=2, res=0.3)``) within 1.5x + 1 mm of the JAX package's
   translation error on the same pair, single scale under 1e-4 m, GICP
   and NDT (the JAX package's test settings) within 1.5x + 1 mm of its
   errors and under the reference's 0.1 (``||T_est - T_true||_F``); the
   ICP transforms within 1e-4 of this machine's CPU's, every matcher's
   bits equal on two card runs, no synchronizing call inside a matcher
   outside ``torch.linalg`` (sync debug mode) and none of the five kernels
   launched; ``bench.py``'s keys (pairs/s multiscale and single scale, the
   numpy SVD-ICP anchor on this machine's CPU and the ratio), LUM and
   Censi information of the multiscale result (symmetric positive
   definite, within rtol 1e-5 of the same estimate on the CPU), the busy
   share of one multiscale match (``torch.profiler``) and what
   ``torch.linalg.svd`` of (1, 3, 3) and (49, 3, 3) costs and syncs;
16. lidar_odometry: ``bench_lidar.scan_sequence(50, 4096)`` (5 s at
   KITTI's 10 Hz; sha256 checked) through ``lidar_odometry`` on the card,
   f32, the 49 pairs in one batch: full-resolution ICP with LUM information
   and the pose-graph refinement (``PoseGraphConfig()``), ``bench.py``'s
   multiscale ICP, and NDT: every pair converged, the worst position error
   within 1.5x + 1 mm of the JAX package's on the same sequence, the same
   bits on two runs, the first 4 pairs within 1e-4 of this machine's CPU's,
   no synchronizing call inside a matcher or ``solve_pose_graph`` outside
   ``torch.linalg``, none of the five kernels; pairs/s, peak allocation,
   and the busy share of the refined run;
17. ground: ``segment_ground`` on ``bench_lidar.ground_scene()`` (116,800
   points, sha256 checked) at the reference's default bins (72 x 200, rmax
   100 m), f32: ground, obstacle and drivable recall and ground precision
   within 0.005 of the JAX package's (under ``jax.jit``) on the same
   scene, labels equal to this machine's CPU's on at least 99.9% of
   points, none of the five kernels; ms per scan;
18. hamming: both Hamming kernels against their plain versions on the card,
   exactly equal (integer outputs), at the frame's 512 x 512 x 16, at an
   unaligned 300 x 700 x 8 with ties, mask zeros, an all-masked bank and a
   single live column, at ``bench_frontend.top2_edge_cases`` (ties across
   and within the top-2's lanes, the only live column last, N2 = 1, 7, 33,
   100, 1,500, 4,500 and 2,200 query rows), the top-2 at 2,048^2 x 16 and
   16,384^2 x 16; the table also at ``bench_frontend.table_edge_cases``
   (W = 1, 2, 4, 8, 16, 32, N1 and N2 of 1, 7, 33, 100 and 4,097, a
   2,048-row bank) and on banks 4 bytes past a 16-byte boundary. Then each
   kernel timed as device time against its plain version: the top-2 at
   the frame, 2,048^2 and 16,384^2; the table at the frame, 4,096^2 and
   8,192^2 x 16 beside ``torch.cdist(p=0)`` on the banks unpacked to 0/1
   f32 bits, with its bound: the bytes (the products on the tensor cores
   take far less);
19. pair: ``bench.py``'s two-frame pair (480x640 blobs and their (4, 7) roll,
   FAST-512, BRISK, knn ratio + RANSAC) on the card: one top-2 launch per
   pair, pairs/s with the kernel and with the plain top-2; then the same pair
   through the distance heuristic with cross check, one table launch per
   pair, the same matches as with the plain table;
20. sequence: the 25 EuRoC-resolution (752x480) frames of ``bench.py``'s
    front-end benchmark through ``track_sequence`` with ``FrontendParams()``:
    25 top-2 launches, tracks identical to the run with the plain top-2,
    contiguous tracks of mean length >= 3, rows and ids within 10% of the JAX
    package's figures on the same frames, frames/s for both runs, ms per
    frame by layer, and the synchronizing calls of one frame step (none
    allowed outside RANSAC's ``torch.linalg`` calls);
21. pixels: ``bench.py``'s pixels sequence (8 s at 5 Hz: 41 frames of
    376x240, 120 landmarks, seed 0) written by the port's simulator with
    its own PNG encoder into a temporary directory, read back by its own
    decoder (equal to the rendered frames bit for bit) and run through
    ``run_euroc_vio_from_images`` on the card: 1 top-2 launch per frame,
    1 G/A, 3 reduce and 1 broadcast per LM iteration, ATE under 0.06 m and
    under half the dead reckoning, >= 60 tracks (the JAX test's bounds),
    tracks equal with the plain top-2; frames/s, solve keyframes/s, the
    front end's busy share and its synchronizing calls per frame;
22. orb: the 25 frames of 20. through ``FrontendParams(method="orb")``:
    one frame's bank on the card against the CPU's (keypoint overlap and
    rBRIEF bits >= 99%), the top-2 at ORB's 512 x 512 x 8 against its
    plain version (exactly) and timed, the tracked sequence (1 top-2 per
    frame, tracks equal with the plain top-2, >= 40 ids of mean length >=
    2: the JAX ORB test's bounds) and ms per frame by layer;
23. lsh: ``bench.py``'s two LSH configurations from its numpy seed: the
    16,384 x 16,384 x 16 planted banks (index and matches equal to the
    CPU's bit for bit, recall, index build s, matches/s; the exact top-2
    kernel at that shape against its plain version, exactly) and one
    512-keypoint frame against a 65,536 map through
    ``MatcherParams(method="lsh")`` (recall, agreement with an exact numpy
    oracle, equal to the CPU's);
24. vo_pair: ``two_frame_pose`` on frames 0 and 2 of 20. with 8
    generators: the median rotation error against the simulator's truth
    within 1.5x + 1e-3 rad of the JAX package's median over 8 keys
    (``tests/vo_anchors.py``), 1 top-2 launch per pair, ms and
    synchronizing calls per pair;
25. batched: 8 copies of 20.'s frames through ``track_sequences_batched``
    (``FrontendParams()``, one generator each): every sequence's tracks
    equal ``track_sequence``'s with its generator, the top-2 launched once
    per sequence per frame, aggregate frames/s against one sequence at a
    time.
26. gps_trajectory: the GPS/INS smoother of ``bench_trajectory``: 200
    states at 10 Hz on a constant twist (numpy seed 0), GPS fixes with a
    0.30 m bias and 3 cm noise written as LLH about a datum on the host,
    on the card back into ENU (``enu_point_from_llh``, f64, within 1e-6 m
    of the CPU's), into a ``MeasurementBuffer`` (``insert_batch``) and
    read back per state (``get_interpolated``); GPS-with-bias, motion,
    decaying-bias (tau 1e9, sqrt_info 100), pose-prior and twist-prior
    banks on a ``PoseVelBiasState`` started 0.1 m off the truth, solved by
    ``solve_trajectory_gn`` (25 iterations, f64, tangent 3,000) under sync
    debug mode with no synchronizing call: the cost trace within rtol 1e-9 of the port's CPU solve
    of the same fixes, the states within 1e-6, the final cost within rtol
    1e-6 of the JAX package's (``tests/trajectory_anchors.py``); position
    and bias errors, ms and CUDA kernels per LM iteration, peak
    allocation;
27. nlls: ``tests/test_nlls.py``'s exponential curve (68 points, numpy
    seed 0) with autodiff, numeric and analytic Jacobians, then 4,096
    fits (one noise draw each) under ``torch.func.vmap``, 100
    iterations, f64, under sync debug mode with no synchronizing call:
    cost traces within rtol 1e-9 of the CPU's, parameters within 1e-8,
    every fit within the JAX test's bounds (|m - 0.3| < 0.02,
    |c - 0.1| < 0.05); fits/s;
28. float_flann: ``tests/test_flann.py``'s planted SIFT-like banks at
    16,384 x 16,384 x 128 f32: ``exact`` equal to an f64 oracle on the
    card in every row whose best and second distances differ by more than
    1e-5 of the best; kdtree, kmeans and composite with the test's
    parameters and with 9 key bits (the test's 32 rows per bucket at this
    size; its parameters leave 256 rows a bucket and keep 96), each recall
    within 0.01 of the JAX package's on the same banks
    (``tests/flann_float_anchors.py``), the 9-bit ones above the JAX
    test's floors (0.85, 0.9, 0.95), candidates below N2; each k-means
    build's 8 segment reduces counted, held to the plain version bit for
    bit, and a second build's centroids equal bit for bit; at the test's
    own 2,048 / 256 each recall within 0.01 of the JAX package's; index
    build seconds and matches/s;
29. leaves: 10^6 LLH points to ECEF and back and to ENU and back (f64); a
    65,536-record, 4-sensor ``MeasurementBuffer`` with 65,536
    interpolated reads (the first 1,024 a sensor against the CPU's, all
    against a numpy searchsorted oracle); a 10,000-step
    ``compose_pose_with_covariance`` chain; 2,000 closed-loop quadrotor
    steps (dt 0.001: at 0.005 the loop saturates and no two roundings
    agree) and 2,000 gimbal steps tracking a target; a 10,000-step
    two-wheel roll-out; ``from_dict`` of ``FloatIndexParams`` and of a
    nested dataclass with a {rows, cols, data} matrix (no PyYAML on the
    card). Each held to the CPU's run: 1e-9 at f64 (1e-6 m for metres
    through ECEF), with its time.
30. distributed: ``parallel/*`` on the one card, ranks being processes of
    this script (``--rank``, started together after the build, each with
    a deadline; a rank that fails or hangs fails the phase): 1 rank over
    a real NCCL group, 2 and 4 over gloo (NCCL puts one rank on a card;
    gloo's collectives stage CUDA tensors through the host, which
    synchronizes). dist_ba at each: the headline problem through
    ``partition_ba_problem`` and ``solve_ba_sharded`` (matrix-free, 10 LM,
    20 CG): 23 reduce and 22 broadcast launches per rank per LM iteration
    (sharded blocks take the plain matvec, whose broadcast gathers y; the
    single-device solve's fused matvec gathers it inside its pose-side
    kernel), one held iteration's calls
    equal to their plain versions bit for bit, the ranks' states equal bit
    for bit, the final cost below the initial, the first iteration of the
    same solve at f64 within rtol 1e-7 of the single-device one's, at f32
    within 3x the single-device solve's own gap between the card and the
    CPU measured in the same run (single-device yardsticks take the plain
    matvec, as sharded blocks do; 20 CG steps amplify any summation order
    past 1e-3), at 1 rank no synchronizing call (sync debug mode); LM
    iterations/s per rank and the collectives' share of an iteration. At
    2 ranks also: a 20-pose f64 problem sharded on the card against the
    same on the CPU (poses and landmarks within 1e-9 m, costs within rtol
    1e-9 + atol 1e-11 of the first iteration's); ``bench_vio``'s problem through
    ``solve_vio_sharded`` (PCG; first iteration within rtol 1e-3 of the
    single-device PCG solve, keyframes/s); the lidar phase's 49 pairs (one
    masked pair added) through ``multi_match_sharded`` within 1.5x + 1 mm
    of one rank's ``multi_match`` error, whether the bits are equal
    printed. At 2 and 4: ``shard_ba_problem`` + ``distributed_lm_step`` on
    the headline problem at f64 on the flat (R, 1) mesh and with landmark
    rows over tp, (1, 2) at 2 ranks, (2, 2) and (1, 4) at 4: the cost
    within rtol 1e-7 of a local LM iteration's, each rank holding ceil(M /
    tp) landmark rows, ranks and dp replicas equal bit for bit, the reduce
    and broadcast launches per rank the flat bank's, one step's calls held
    to the plain versions bit for bit, each rank's landmark-side bytes and
    peak memory printed; ``bench_parallel.circle_graph(1997)`` (f64;
    every closure kind) through ``solve_pose_graph_blocks``, the final
    cost within rtol 1e-6 of ``solve_pose_graph`` on the card,
    ``unpartition`` giving the poses back. Numbers of ranks sharing one
    card: no figure of scaling across cards;
31. pp_overlap: ``bench.py``'s 8 windows (480x640 blobs: FAST-512 + BRISK
    + top-2 match; RANSAC 2,048 hypotheses + essential + pose) serial and
    on two CUDA streams (``pipelines.overlap``): one top-2 launch a window,
    results equal bit for bit; s/window for each and the ratio;
32. utils (in a child process of this script, ``--utils``, so that its
    profiler session leaves no hooks in this one): ``utils.timing.Timer``
    against CUDA events around 200 segment reduces (within 5% + 0.05 ms),
    and ``utils.trace.profile_trace``'s trace naming the segment reduce
    kernel.

The line before the last is a JSON object describing each kernel (its
launches on its main path, its largest difference from the plain version,
its time, the plain version's and the library call's, and its bound: the
larger of the bytes it must move over 3.35 TB/s and its operations over
67 TFLOP/s, the H100 SXM's HBM rate and non-tensor f32 rate; the top-2's
XOR + popcount word operations over the popcount issue rate, 16 per SM per
clock at this card's SM count and maximum SM clock; the table's bit
operations, an AND and an add per bit pair, over the .b1 rate measured in
this run; the three matvec kernels at venice-mf's shape, launches per
headline matrix-free solve, ``replaces`` null: no Pallas kernel); the last
line is ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero without that line.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import importlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import types
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import libwave_tpu_torch
from libwave_tpu_torch import (
    bench_frontend,
    bench_lidar,
    bench_problem,
    bench_trajectory,
    bench_windowed,
    kinematics,
    native,
)
from libwave_tpu_torch.ops import _build, hamming, segmm
from libwave_tpu_torch.benchmark import Trajectory, absolute_trajectory_error
from libwave_tpu_torch.containers import measurement
from libwave_tpu_torch.geography import world_frame
from libwave_tpu_torch.geometry import pose_cov, so3
from libwave_tpu_torch.geometry.se3 import SE3
from libwave_tpu_torch.matching import (
    estimate_info_censi,
    estimate_info_lum,
    gicp_match,
    icp_match,
    ndt_match,
    segment_ground,
)
from libwave_tpu_torch.matching.pointcloud import PointCloud, make_cloud
from libwave_tpu_torch.kinematics import gimbal
from libwave_tpu_torch.optim import ba, factors, nlls, schur
from libwave_tpu_torch.optim.pose_graph import (
    BetweenBank,
    PoseGraphConfig,
    PriorBank,
    solve_pose_graph,
)
from libwave_tpu_torch.parallel.dist_ba import to_device
from libwave_tpu_torch.datasets.euroc import load_euroc_camera_index
from libwave_tpu_torch.pipelines import (
    LidarOdometryConfig,
    euroc_vio,
    lidar_odometry,
    vio,
    visual_frontend,
    vo_frontend,
    windowed_ba,
    windowed_vio,
)
from libwave_tpu_torch.sim import euroc_sim, vo_dataset
from libwave_tpu_torch.utils import config as utils_config
from libwave_tpu_torch.utils import precision, trace
from libwave_tpu_torch.vision import flann, flann_float, images, matcher
from libwave_tpu_torch.vision.descriptor import (
    brisk_describe,
    orb_describe_pyramid,
)
from libwave_tpu_torch.vision.detector import (
    FASTParams,
    detect_fast,
    detect_orb_pyramid,
)
from libwave_tpu_torch.vision.tracker import add_image_features, tracker_init

HERE = Path(__file__).resolve().parent
KERNEL_SOURCE = "libwave_tpu_torch/csrc/segmm_g_a.cu"
KERNEL_REPLACES = "libwave_tpu/ops/segmm.py:190"
HAMMING_SOURCE = "libwave_tpu_torch/csrc/hamming.cu"
TOP2_REPLACES = "libwave_tpu/ops/hamming.py:103"
TABLE_REPLACES = "libwave_tpu/ops/hamming.py:27"
SEG_SOURCE = "libwave_tpu_torch/csrc/segmm_seg.cu"
MATVEC_SOURCE = "libwave_tpu_torch/csrc/schur_matvec.cu"
# the matvec kernels replace no Pallas kernel: the JAX package's
# schur_matvec (libwave_tpu/optim/schur.py:653) is one XLA fusion
MATVEC_REPLACES = None
PCG_SOURCE = "libwave_tpu_torch/csrc/schur_pcg.cu"
# nor does the CG trip: the JAX package runs pcg's loop body as one XLA
# fusion inside lax.scan (libwave_tpu/optim/schur.py:1089)
PCG_REPLACES = None
PRECOND_SOURCE = "libwave_tpu_torch/csrc/schur_precond.cu"
# nor does the preconditioner's self-blocks kernel: the JAX package's
# _schur_self_blocks (libwave_tpu/optim/schur.py:689) is one XLA fusion
PRECOND_REPLACES = None
REDUCE_REPLACES = "libwave_tpu/ops/segmm.py:65"
BROADCAST_REPLACES = "libwave_tpu/ops/segmm.py:117"
# the H100 SXM's published HBM rate and non-tensor f32 rate (NVIDIA's data
# sheet), the denominators of every kernel's bound
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# __popc issues at 16 per SM per clock on Hopper (sm_90): the Hamming
# kernels' rate is this times the SM count times the maximum SM clock
POPC_PER_SM_CLOCK = 16
LM_ITERS = 10
# ba_dataset: tests/test_ba.py's dataset, landmarks from draw_landmarks;
# the noisy case's pixels from a CPU generator (tests/ba_noise_draws.py:
# the offline example's bounds hold for some draws, as in the JAX package)
BA_DATASET = dict(nb_landmarks=100, steps=300, fx=200.0, fy=200.0, hz=10.0)
BA_DATASET_SEED = 7
BA_NOISE_SEED = 0
BA_LARGE_ITERS = 5  # bench.py's bench_ba_large
BAND_CALLS = 13  # band plan entries x pose runs of the headline problem
REL_TOL = 1e-6
# The JAX package's track_sequence(frames, FrontendParams()) on the same 25
# frames (bench_frontend.make_euroc_frames(), bit-identical to its PNGs), run
# on a CPU with jax_enable_x64 in its default (scan) mode: 1,435 track rows,
# 373 landmark ids, mean track length 3.847. The card has no JAX.
JAX_TRACK_ROWS = 1435
JAX_TRACK_IDS = 373
SEQUENCE_FRAMES = 25
# bench.py's euroc phase (bench_euroc): the sequence and its seed
EUROC_SIM = euroc_sim.EurocSimParams(duration=16.0, nb_landmarks=200)
EUROC_SEED = 3
EUROC_ATE_BOUND_M = 0.03  # the JAX package's bound, tests/test_euroc_vio.py
# bench.py's euroc_long phase (bench_euroc_long), in full: 651 keyframes
WINDOWED_SIM = bench_windowed.LONG_SIM
WINDOWED_ATE_BOUND_M = 0.05  # the JAX package's, tests/test_windowed_vio.py
# bench.py's euroc_mh01_scale configuration at its widths (20 Hz camera,
# 200 Hz IMU, 900 landmarks, W=120, O=12), its 182 s cut to 36 s (721
# keyframes, 7 windows) to fit this script's time
MH01_SIM = dataclasses.replace(bench_windowed.MH01_SIM, duration=36.0)
# The JAX package's run_euroc_vio_windowed (f32 with explicit f64, as
# bench.py runs it) on the same directories, written by this port's
# generate_euroc_sequence with a CPU generator, on a CPU: ATE in m, and the
# sha256 of the directories' imu0/data.csv and cam0/tracks.csv there
# (tests/windowed_anchors.py long jax32, mh01_36 jax32).
JAX_WINDOWED_ATE = {"marginalize_2pass": 0.022929711267352104,
                    "freeze": 0.030840111896395683}
JAX_MH01_ATE = 0.057505033910274506
SEQUENCE_SHA256 = {
    "windowed": ("5c10acfb06069452169a36b28e3cec39a597312bc6a6c048ff73f8f26fa2ab67",
                 "def2627aba3eabad8923ef0bd5798e316385c14a11951b645f13b57bd87dcf29"),
    "mh01_scale": ("3b1ba5f05e9b34bbd0828ff98029b4213792c695a4867b769590587fddb3b586",
                   "ffb3097319cdfa8c71912bafed7195d3c450929e3eab2bea96e49ffd4d37739e"),
}
# windowed_ba: the JAX package's test circle, its bounds (the reference's
# gtsam_offline_example.cpp:150,155)
WBA_POS_BOUND_M = 0.1
WBA_ROT_BOUND_RAD = 0.05
# The lidar phases: the JAX package's figures on bench_lidar's arrays (the
# sha256 checked below), f32 with x64 off, on a CPU (tests/lidar_anchors.py
# icp, odometry, ground). Errors in m.
JAX_ICP_ERR = {"multiscale": 0.0023430006112903357,
               "singlescale": 1.6496770172125252e-07,
               "gicp": 1.5545874703093432e-05,
               "ndt": 0.013194199651479721}
JAX_ODOMETRY_ERR = {"icp_refined": 1.529524295691402e-05,
                    "icp_multiscale": 0.17166224129209845,
                    "ndt": 0.21223523547441853}
# segment_ground under jax.jit: the port computes the compiled program's
# select (ROADMAP.md C); without jit the JAX package's drivable recall
# reads 0.952083 on the same scene
JAX_GROUND = {"ground_recall": 0.97096875, "obstacle_recall": 0.994875,
              "drivable_recall": 1.0,
              "ground_precision": 0.9991639064861563}
ICP_THRESHOLD = 0.1  # ||T_est - T_true||_F, the reference's icp_tests.cpp
SINGLESCALE_BOUND_M = 1e-4
# card vs this machine's CPU, f32: transforms (translation m, quaternion
# components) of the pair and of the sequence's first 4 pairs (measured at
# most 2.1e-5, the multiscale sequence run), and the information of one ICP
# result on both (measured 2.3e-7 of the largest entry; NVIDIA H100 80GB
# HBM3, 700 W, torch 2.11)
CARD_CPU_T_TOL = 1e-4
CARD_CPU_INFO_RTOL = 1e-5
GROUND_SCORE_TOL = 0.005
GROUND_AGREE = 0.999
ODOMETRY_T = 50
ODOMETRY_CPU_PAIRS = 4
# pixels: bench.py's bench_pixels sequence (8 s at 5 Hz, 41 frames, 120
# landmarks, 376x240, seed 0) and the JAX test's bounds
# (tests/test_pixels_to_trajectory.py:114-125)
PIXELS_SIM = euroc_sim.EurocSimParams(
    duration=8.0, cam_hz=5.0, nb_landmarks=120, fx=229.0, fy=228.0,
    cx=188.0, cy=120.0, width=376, height_px=240, render_images=True)
PIXELS_ATE_BOUND_M = 0.06
PIXELS_MIN_TRACKS = 60
# orb: the JAX ORB test's bounds (tests/test_pixels_to_trajectory.py:92-103)
ORB_MIN_IDS = 40
ORB_MIN_MEAN_LENGTH = 2.0
ORB_AGREE = 0.99  # keypoint overlap and rBRIEF bits, card vs this CPU
# lsh: bench.py's bench_lsh configurations (numpy seed 3)
LSH_N, LSH_WORDS, LSH_FLIPS = 16384, 16, 20
LSH_MAP, LSH_QUERIES = 65536, 512
# vo_pair: the JAX package's two_frame_pose on frames 0 and 2 of the orb
# sequence, VOFrontendConfig(), f32 with x64 off, jax.random.key(0..7), on a
# CPU: the median rotation error (rad) against the simulator's truth
# (tests/vo_anchors.py)
JAX_VO_ROT_ERR = 0.01935679592331921
VO_SEEDS = 8
BATCH = 8  # batched: B copies of the orb sequence
# the port's lidar modules: a synchronizing call made while a matcher or
# the pose-graph solve is on the stack fails outside their torch.linalg
# calls
LIDAR_MODULES = tuple(importlib.import_module(f"libwave_tpu_torch.{m}") for m in (
    "matching.pointcloud", "matching.knn", "matching.loop", "matching.icp",
    "matching.gicp", "matching.ndt", "optim.pose_graph"))

# The trajectory back end and the leaves (gps_trajectory, nlls, float_flann,
# leaves). JAX anchors, from `JAX_PLATFORMS=cpu python
# tests/trajectory_anchors.py` and `... tests/flann_float_anchors.py`:
JAX_GPS_FINAL_COST = 0.14777103915596304
JAX_FLANN_RECALL = {
    "test_2048/kdtree": 0.984375, "test_2048/kmeans": 1.0,
    "test_2048/composite": 1.0,
    "test_16384/kdtree": 0.4434814453125,
    "test_16384/kmeans": 0.3729248046875,
    "test_16384/composite": 0.45831298828125,
    "bits9_16384/kdtree": 0.93646240234375,
    "bits9_16384/kmeans": 0.99664306640625,
    "bits9_16384/composite": 0.999755859375,
}
GPS_CPU_RTOL = 1e-9  # card vs CPU cost trace
GPS_STATE_TOL = 1e-6  # card vs CPU states (m; the other fields alike)
GPS_JAX_RTOL = 1e-6  # final cost against the JAX package's
NLLS_BATCH = 4096
NLLS_RTOL = 1e-9  # card vs CPU cost trace
# card vs CPU parameters: the cost is flat at the minimum, and a cost within
# rtol 1e-9 (1.1e-11 of 0.011, curvature ~1e4) leaves them ~5e-8 apart
NLLS_X_TOL = 1e-8
FLANN_N = 16384
LEAF_SEED = 12
LEAF_F64_TOL = 1e-9  # card vs CPU at f64 (degrees, unitless, seconds)
LEAF_M_TOL = 1e-6  # card vs CPU in metres through ECEF (~6.4e6 m)
LEAF_POINTS = 1_000_000
LEAF_RECORDS = 65_536
LEAF_CPU_READS = 1024  # reads a sensor the CPU run repeats
LEAF_CHAIN = 10_000
LEAF_HOVER_STEPS = 2000
# the JAX tests' step: at 0.005 s the attitude loop saturates its motors on
# 1,550 of 2,000 steps, and a 1e-13 m start offset grows to 0.1 m by step
# 1,000 (f64, CPU), so no two roundings agree; at 0.001 s it stays 1e-13
LEAF_HOVER_DT = 0.001
LEAF_HOVER_START = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
LEAF_HOVER_TARGET = (1.0, 0.0, 2.0)
LEAF_GIMBAL_STEPS = 2000
LEAF_ROLLOUT = 10_000


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device: this script runs only "
          "on an NVIDIA GPU")
    check(
        Path(libwave_tpu_torch.__file__).resolve().parent.parent == HERE,
        f"libwave_tpu_torch imported from {libwave_tpu_torch.__file__}, not "
        f"from this checkout",
    )
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_rate = POPC_PER_SM_CLOCK * sms * float(clock) * 1e6
    print(f"device: {name} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s) | "
          f"{sms} SMs, max SM clock {clock} MHz: {popc_rate:.4e} popcounts/s "
          f"({POPC_PER_SM_CLOCK} per SM per clock)")
    print(f"nvidia-smi: {smi}")
    return name, smi, popc_rate


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in trace.counted_wrappers().values():
        fn.launches = 0


def _is_matvec(name):
    # the matrix-free matvec's own kernels are counted apart: only
    # matrix-free PCG solves launch them (matvec_launches)
    return name.startswith("matvec_")


def launch_counts():
    """Every counted wrapper's launch count since the last reset, by name
    (``utils.trace.counted_wrappers``), but the matvec's; ``pcg_trip``
    counts the CG trip kernel's calls (one a CG trip of a float32 solve on
    the card)."""
    return {name: fn.launches
            for name, fn in trace.counted_wrappers().items()
            if not _is_matvec(name)}


def cg_trips(cfg, dtype):
    """Calls of the CG trip kernel one ``schur.pcg`` solve at ``cfg`` makes
    on the card: every trip in float32, none in f64."""
    return cfg.cg_max_iters if dtype == torch.float32 else 0


def matvec_launches():
    """The matvec kernels' launch counts since the last reset."""
    return {name: fn.launches
            for name, fn in trace.counted_wrappers().items()
            if _is_matvec(name)}


def bound(nbytes, ops=0.0, ops_per_s=ALU_OPS_PER_S):
    """(bound_ms, bound_by): the larger of moving ``nbytes`` over the HBM
    rate and doing ``ops`` at ``ops_per_s`` (by default the non-tensor f32
    rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed_build(lib):
    t0 = time.perf_counter()
    log = _build.build(lib)
    return log, time.perf_counter() - t0


def phase_build():
    """One nvcc per library, all started together."""
    libs = list(_build.LIBRARIES.values())
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        results = list(pool.map(_timed_build, libs))
    for lib, (log, dt) in zip(libs, results):
        sources = ", ".join(f"libwave_tpu_torch/csrc/{s}" for s in lib.sources)
        print(f"build: {sources} built for sm_90a and loaded in {dt:.3f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: ptxas: {line.strip()}")


def _compare(case, G, A, Gr, Ar, worst, single=None):
    """Within 1e-6 * max|plain|; bit for bit at the cells in ``single``
    (those that take at most one nonzero slot)."""
    for what, x, ref in (("G", G, Gr), ("A", A, Ar)):
        scale = float(ref.abs().max())
        err = float((x - ref).abs().max())
        rel = err / scale if scale > 0 else err
        worst["abs"] = max(worst["abs"], err)
        worst["rel"] = max(worst["rel"], rel)
        check(
            err <= REL_TOL * scale,
            f"kernel {case} {what}: max abs err {err:.3e} > "
            f"{REL_TOL:g} * max|plain| = {REL_TOL * scale:.3e}",
        )
        if single is not None:
            bad = int((x != ref)[single.expand_as(x)].sum())
            check(bad == 0, f"kernel {case} {what}: {bad} cells with at most "
                  f"one nonzero slot differ from the plain version")


def _nonzero_slots(W, ids, M):
    """(N, 1, M) count of the slots with a nonzero W that name each column
    (ids outside [0, M) name none)."""
    ok = (ids >= 0) & (ids < M) & (W != 0).any(0)
    count = torch.zeros((ids.shape[0], M), dtype=torch.int32, device=W.device)
    count.scatter_add_(1, torch.where(ok, ids, 0).long(), ok.int())
    return count[:, None, :]


def _check_window(case, W, ell, lm_slot, hinv, window, worst):
    """The window kernel against its plain version and against the plain
    G/A of the window's slices of W, lm_slot - c0 and hinv (the operands
    the dense reduced system cut per build call before the window entry)."""
    c0, c1, plo, phi = window
    G, A = segmm.dense_g_a_window(W, ell, hinv, *window)
    Gw, Aw = segmm.dense_g_a_window_reference(W, ell, hinv, *window)
    ids = lm_slot[plo:phi] - c0
    Gr, Ar = segmm.dense_g_a_reference(W[:, plo:phi], ids, hinv[:, c0:c1])
    single = _nonzero_slots(W[:, plo:phi], ids, c1 - c0) <= 1
    torch.cuda.synchronize()
    _compare(case, G, A, Gw, Aw, worst, single)
    _compare(f"{case} (slices)", G, A, Gr, Ar, worst, single)


def _left_out(W, ell):
    """(slots the layout lists in no run, largest |W| among them)."""
    listed = torch.zeros(W.shape[1] * W.shape[2], dtype=torch.bool,
                         device=W.device)
    listed[ell.sigma[int(ell.offsets[0]):int(ell.offsets[-1])].long()] = True
    out = ~listed.reshape(W.shape[1:])
    return int(out.sum()), float(W[:, out].abs().max()) if out.any() else 0.0


def _time_calls(fn, operands, reps=20):
    """Device ms per pass over ``operands`` (``bench_problem.device_ms``:
    CUDA events around a CUDA graph's replay)."""
    def one_pass():
        for ops in operands:
            fn(*ops)

    return bench_problem.device_ms(one_pass, reps)


def phase_kernel(problem, state, cfg):
    lam = torch.tensor(cfg.init_lambda, dtype=state.p.dtype,
                       device=state.p.device)
    with precision.full_f32():
        blocks = ba._linearize_ba(problem, state, lam)
    calls = [
        (c0, c1, plo, phi)
        for (c0, c1, ranges) in problem.bands.entries
        for (plo, phi) in ranges
    ]
    check(len(calls) == BAND_CALLS,
          f"headline band plan has {len(calls)} G/A calls, expected "
          f"{BAND_CALLS}")
    W, ell, hinv = blocks.W, blocks.ell, blocks.Hll_inv
    N, P = W.shape[1:]
    lm_slot = blocks.lm_idx.reshape(N, P)
    # the kernel takes a slot's W only from the layout's runs: the slots the
    # layout leaves out (zero weight) must hold W exactly 0
    n_out, w_out = _left_out(W, ell)
    check(w_out == 0.0, f"kernel: {n_out} slots left out of the layout's runs "
          f"hold W up to {w_out:.3e}, not exactly 0")
    worst = {"abs": 0.0, "rel": 0.0}
    for c in calls:
        _check_window(f"band cols [{c[0]},{c[1]}) poses [{c[2]},{c[3]})",
                      W, ell, lm_slot, hinv, c, worst)
    cells = sum((phi - plo) * (c1 - c0) for (c0, c1, plo, phi) in calls)
    print(f"kernel: {len(calls)} headline band calls ({cells} pose x column "
          f"cells) through the window entry match its plain version and the "
          f"plain G/A of each call's slices of W, lm_slot and hinv: max abs "
          f"err {worst['abs']:.3e}, max rel err {worst['rel']:.3e}, equal "
          f"bit for bit at every cell with at most one nonzero slot; the "
          f"{n_out} slots left out of the layout's runs hold W exactly 0")
    names = []
    for name, *arrays, windows in bench_problem.g_a_edge_cases():
        Wc, ids, hc = (torch.as_tensor(a, device=state.p.device)
                       for a in arrays)
        M = hc.shape[1]
        G, A = segmm.dense_g_a(Wc, ids, hc)
        Gr, Ar = segmm.dense_g_a_reference(Wc, ids, hc)
        torch.cuda.synchronize()
        _compare(f"edge case {name} (reference signature)", G, A, Gr, Ar,
                 worst, _nonzero_slots(Wc, ids, M) <= 1)
        ell_c = segmm.sorted_layout(ids.reshape(-1), M)
        for window in windows:
            _check_window(f"edge case {name} window {window}", Wc, ell_c,
                          ids, hc, window, worst)
        names.append(f"{name}: {len(windows)} windows")
    print(f"kernel: edge cases through dense_g_a and dense_g_a_window ("
          f"{'; '.join(names)}) match: overall max abs err "
          f"{worst['abs']:.3e}, max rel err {worst['rel']:.3e} (limit "
          f"{REL_TOL:g} * max|plain|)")
    stats = _g_a_timing("kernel: one LM iteration's", W, ell, hinv, calls)
    return {"max_abs_err": worst["abs"], **stats, "library_ms": None}


def _g_a_timing(what, W, ell, hinv, calls, reps=20):
    """Device ms of the G/A ``calls`` (c0, c1, plo, phi) through the kernel
    and its plain version (graphs of ``reps`` passes), and their bound;
    printed after ``what``."""
    P = W.shape[2]
    cells = sum((phi - plo) * (c1 - c0) for (c0, c1, plo, phi) in calls)
    operands = [(W, ell, hinv, *c) for c in calls]
    ms = _time_calls(segmm.dense_g_a_window, operands, reps)
    # the plain version reads its largest id multiplicity on the host (it
    # sums a cell's slots in slot order, pass by pass): a CUDA graph cannot
    # capture it, so it is timed on a synchronized host clock
    plain_ms = bench_problem.wall_ms(
        lambda: [segmm.dense_g_a_window_reference(*ops) for ops in operands],
        reps)
    out_mb = 2 * 4 * 18 * cells / 1e6
    # bytes: each slot of a call's window read once (its 18 W values and
    # its sigma entry), the window's offsets and hinv columns, G and A
    # written once; operations: the G sums (one add per W value) and A's 3
    # multiply-adds per value
    pose = ell.sigma.long() // P
    slots = 0
    for c0, c1, plo, phi in calls:
        run = pose[int(ell.offsets[c0]):int(ell.offsets[c1])]
        slots += int(((run >= plo) & (run < phi)).sum())
    cols = sum(c1 - c0 for (c0, c1, _, _) in calls)
    nbytes = slots * (18 + 1) * 4 + cols * (6 + 1) * 4 + 2 * 4 * 18 * cells
    ops = 18 * slots + 18 * 6 * cells
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"{what} {len(calls)} G/A calls take {ms:.4f} "
          f"ms (kernel, device time) vs {plain_ms:.4f} ms (plain, host "
          f"clock); {out_mb:.1f} MB of G "
          f"and A written, {out_mb / ms / 1e3:.3f} TB/s (kernel); {slots} "
          f"slots in the windows; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB, {ops:.3e} ops); no single PyTorch call "
          f"computes G and A")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _g_a(plain):
    """Route the solve's G/A build to the kernel or to the plain version."""
    return mock.patch.object(
        schur, "dense_g_a_window",
        segmm.dense_g_a_window_reference if plain else segmm.dense_g_a_window,
    )


def _solve(problem, state, cfg, plain=False):
    with _g_a(plain):
        out, info = ba.solve_ba(problem, state, cfg)
    torch.cuda.synchronize()
    return out, info


def phase_headline(problem, state, cfg, smi):
    N, M = problem.free_pose.shape[0], state.lm.shape[0]
    check(
        ba._use_explicit_s(cfg, N, 6, M, 4, problem.ell, None, problem.bands,
                           device=state.p.device),
        "the headline problem does not take the explicit-S path",
    )
    # the solve must turn TF32 off whatever the caller set
    tf32_seen = []
    real_pcg = schur.pcg

    def pcg_spy(*args, **kwargs):
        tf32_seen.append(precision.tf32_enabled())
        return real_pcg(*args, **kwargs)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        # the LM and CG loops must never wait on the device: PyTorch's sync
        # debug mode warns on every synchronizing call it detects
        with mock.patch.object(schur, "pcg", pcg_spy), _g_a(plain=False), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reset_launches()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, info = ba.solve_ba(problem, state, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            counts = launch_counts()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    if syncs:
        raise SmokeFailure(
            f"{len(syncs)} synchronizing CUDA calls inside solve_ba, first "
            f"at {syncs[0].filename}:{syncs[0].lineno}"
        )
    # per LM iteration: 13 G/A calls; the Hll and bl reduces of the normal
    # equations and back-substitution's reduce; schur_rhs's broadcast (the
    # explicit-S preconditioner is read off S: no broadcast); one trip
    # kernel call a CG trip
    want = dict(dense_g_a_window=BAND_CALLS * LM_ITERS,
                seg_reduce_sorted=3 * LM_ITERS, seg_broadcast=LM_ITERS,
                hamming_top2=0, hamming_distance=0,
                pcg_trip=cg_trips(cfg, state.p.dtype) * LM_ITERS,
                schur_self_blocks=0)
    check(counts == want, f"headline: launches {counts} in {LM_ITERS} LM "
          f"iterations, expected {want}")
    launches_ga = counts["dense_g_a_window"]
    check(len(tf32_seen) == LM_ITERS and not any(tf32_seen),
          f"TF32 was on inside solve_ba ({tf32_seen})")
    c0 = float(info["initial_cost"])
    costs = info["costs"].cpu().numpy().astype(np.float64)
    check(np.isfinite(c0) and np.isfinite(costs).all(),
          f"non-finite costs: {c0}, {costs}")
    check(costs[-1] < c0, f"final cost {costs[-1]} not below initial {c0}")
    print(f"headline: explicit-S path, {launches_ga} G/A, "
          f"{counts['seg_reduce_sorted']} reduce and "
          f"{counts['seg_broadcast']} broadcast kernel launches and "
          f"{counts['pcg_trip']} CG trip "
          f"kernel calls in {LM_ITERS} LM iterations, TF32 "
          f"off, no synchronizing call detected inside solve_ba; cost "
          f"{c0:.6e} -> "
          f"{costs[-1]:.6e}, accepted "
          f"{int(info['accepted'].sum())}/{LM_ITERS}")
    _, info_p = _solve(problem, state, cfg, plain=True)
    costs_p = info_p["costs"].cpu().numpy().astype(np.float64)
    rel = np.abs(costs - costs_p) / np.abs(costs_p)
    check(np.allclose(costs, costs_p, rtol=1e-3, atol=0.0),
          f"kernel trajectory {costs} vs plain G/A trajectory {costs_p}")
    print(f"headline: cost trajectory matches the plain-G/A solve on the "
          f"card (max rel diff {rel.max():.3e}, rtol 1e-3): "
          f"{' '.join(f'{c:.6e}' for c in costs)}")

    rates = {"kernel": [], "plain": []}
    final = {}
    for which in ("kernel", "plain", "plain", "kernel"):
        with _g_a(plain=which == "plain"):
            rate, cost = bench_problem.bench_backend(problem, state, LM_ITERS)
        rates[which].append(rate)
        final[which] = cost
    print(f"headline: {np.median(rates['kernel']):.4f} LM iterations/s with "
          f"the G/A kernel (runs {rates['kernel'][0]:.4f}, "
          f"{rates['kernel'][1]:.4f}), final cost {final['kernel']:.6e} | "
          f"{smi}")
    print(f"headline: {np.median(rates['plain']):.4f} LM iterations/s with "
          f"the plain G/A (runs {rates['plain'][0]:.4f}, "
          f"{rates['plain'][1]:.4f}), final cost {final['plain']:.6e} | "
          f"{smi}")
    return launches_ga


def phase_small_reference(dev):
    """The same small f64 solve on the card and on the CPU (matrix-free
    PCG: the f32-only G/A kernel is checked above)."""
    cfg = dataclasses.replace(bench_problem.bench_config(3),
                              explicit_s="never")
    out = {}
    for device in (torch.device("cpu"), dev):
        problem, state = bench_problem.make_problem(
            num_poses=20, num_landmarks=500, obs_per_pose=40, device=device
        )
        problem = problem._replace(
            K=problem.K.double(), uv=problem.uv.double(),
            weight=problem.weight.double(),
            free_pose=problem.free_pose.double(),
        )
        state = ba.BAState(*(x.double() for x in state))
        _, info = ba.solve_ba(problem, state, cfg)
        out[device.type] = info["costs"].cpu().numpy()
    check(np.allclose(out["cuda"], out["cpu"], rtol=1e-6, atol=0.0),
          f"small f64 solve: card {out['cuda']} vs CPU {out['cpu']}")
    print(f"reference: small f64 problem (20 poses, 500 landmarks) solves "
          f"alike on the card and the CPU (rtol 1e-6): "
          f"{' '.join(f'{c:.9e}' for c in out['cuda'])}")


def _seg_compare(case, kern, got, ref, stats):
    """Largest |kernel - plain|; the kernel must equal its plain version
    bit for bit (both add in slot order; the broadcast copies)."""
    err = (got.double() - ref.double()).abs()
    stats["max_abs_err"] = max(stats["max_abs_err"], float(err.max()))
    check(torch.equal(got, ref), f"seg {case}: {kern} kernel and plain "
          f"version differ at {int((got != ref).sum())} outputs (max abs "
          f"err {float(err.max()):.3e})")


def _seg_cases(problem, dev):
    """(name, C, dtype, sigma, offsets, idx, M) cases: the headline layout,
    the matrix-free profile's 2,400 observations per pose, ba_large's
    problem, and small edge cases."""
    ell = problem.ell
    M = problem.bands.entries[-1][1]
    big, _ = bench_problem.make_problem(obs_per_pose=2400, device=dev)
    large, _ = bench_problem.ba_large_problem(device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    edge = torch.randint(-3, 780, (12_345,), generator=gen, device=dev,
                         dtype=torch.int32)
    edge[100:400] = 500  # a long run; ids 777..779 and < 0 are outside
    long_runs = torch.randint(0, 500, (60_000,), generator=gen, device=dev,
                              dtype=torch.int32)  # runs of ~120 slots
    return [
        ("headline C=3", 3, torch.float32, ell.sigma, ell.offsets,
         problem.lm_idx, M),
        ("headline C=6", 6, torch.float32, ell.sigma, ell.offsets,
         problem.lm_idx, M),
        ("headline C=3 f64", 3, torch.float64, ell.sigma, ell.offsets,
         problem.lm_idx, M),
        ("profile K=480,000", 3, torch.float32, big.ell.sigma,
         big.ell.offsets, big.lm_idx, M),
        ("ba_large K=600,000 M=100,000", 3, torch.float32, large.ell.sigma,
         large.ell.offsets, large.lm_idx, 100_000),
        ("edge C=1 K=12,345 M=777, ids < 0 and >= M, empty segments", 1,
         torch.float32, *segmm.sorted_layout(edge, 777), edge, 777),
        ("edge long runs C=6 f64 K=60,000 M=500", 6, torch.float64,
         *segmm.sorted_layout(long_runs, 500), long_runs, 500),
        ("edge C=5 f64 K=12,345 M=777", 5,
         torch.float64, *segmm.sorted_layout(edge, 777), edge, 777),
    ]


def phase_seg(problem, dev, smi):
    stats = {k: {"max_abs_err": 0.0} for k in ("seg_reduce", "seg_broadcast")}
    gen = torch.Generator(device=dev).manual_seed(6)
    timed = {}
    for name, C, dtype, sigma, offsets, idx, M in _seg_cases(problem, dev):
        K = idx.shape[0]
        vals = torch.randn((C, K), generator=gen, device=dev, dtype=dtype)
        out = segmm.seg_reduce_sorted(vals, sigma, offsets)
        again = segmm.seg_reduce_sorted(vals, sigma, offsets)
        ref = segmm.seg_reduce_sorted_reference(vals, sigma, offsets)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"seg {name}: two reduce runs are not bit-identical")
        _seg_compare(name, "reduce", out, ref, stats["seg_reduce"])
        generic = segmm.seg_reduce(vals, idx, M)
        check(torch.equal(generic, segmm.seg_reduce_reference(vals, idx, M)),
              f"seg {name}: seg_reduce (device sort) differs from its plain "
              f"version")
        y = torch.randn((C, M), generator=gen, device=dev, dtype=dtype)
        # the broadcast also sees ids < 0 and >= M
        bidx = idx.clone()
        bidx[:7] = torch.tensor([-1, -5, M, M + 3, 0, M - 1, 2**30],
                                dtype=torch.int32, device=dev)
        _seg_compare(name, "broadcast", segmm.seg_broadcast(y, bidx),
                     segmm.seg_broadcast_reference(y, bidx),
                     stats["seg_broadcast"])
        timed[name] = (vals, sigma, offsets, idx, y, M)
    edges = 0
    for name, y, ids, off in bench_problem.broadcast_edge_cases():
        for dtype in (torch.float32, torch.float64):
            yt = torch.as_tensor(y, device=dev).to(dtype)
            idx = torch.as_tensor(ids, device=dev)[off:]
            _seg_compare(f"broadcast edge {name} {dtype}", "broadcast",
                         segmm.seg_broadcast(yt, idx),
                         segmm.seg_broadcast_reference(yt, idx),
                         stats["seg_broadcast"])
            edges += 1
    print(f"seg: reduce and broadcast equal their plain versions bit for bit "
          f"(max abs err {stats['seg_reduce']['max_abs_err']:.3e} and "
          f"{stats['seg_broadcast']['max_abs_err']:.3e}), the reduce "
          f"bit-identical across two runs, at {', '.join(timed)}; the "
          f"broadcast also at {edges} edge cases (K = 1, 3, 4,096, 4,097; "
          f"C = 1, 3, 5, 6; M = 300 and 22,000; ids with storage offset 0 "
          f"and 1; f32 and f64)")

    for name, (vals, sigma, offsets, idx, y, M) in timed.items():
        if name.startswith("edge") or "f64" in name:
            continue
        C, K = vals.shape
        used = int(offsets[-1])  # slots that belong to a segment
        idx_l = idx.long()
        zeros = torch.zeros((C, M), dtype=vals.dtype, device=dev)
        ypad = torch.cat([y, torch.zeros_like(y[:, :1])], dim=1)
        clamped = torch.where((idx >= 0) & (idx < M), idx_l, M)
        t = {
            "seg_reduce": (
                bench_problem.device_ms(
                    lambda: segmm.seg_reduce_sorted(vals, sigma, offsets)),
                # it synchronizes: host clock
                bench_problem.wall_ms(
                    lambda: segmm.seg_reduce_sorted_reference(
                        vals, sigma, offsets), reps=5),
                bench_problem.device_ms(
                    lambda: zeros.clone().index_add_(1, idx_l, vals)),
                # the vals and sigma of the slots in a segment and the
                # offsets read once, the sums written once
                bound((C * used + C * M) * vals.element_size()
                      + (used + M + 1) * 4, C * used),
            ),
            "seg_broadcast": (
                bench_problem.device_ms(lambda: segmm.seg_broadcast(y, idx)),
                bench_problem.device_ms(
                    lambda: segmm.seg_broadcast_reference(y, idx), reps=20),
                bench_problem.device_ms(
                    lambda: ypad.index_select(1, clamped)),
                # y and the ids read once, the gathered values written once
                bound((C * M + C * K) * y.element_size() + K * 4),
            ),
        }
        # the reduce gathers vals[c, sigma[p]]: each 4- or 8-byte value in
        # its own 32-byte sector, C * used sector reads
        sectors_mb = C * used * 32 / 1e6
        for kern, (ms, plain_ms, lib_ms, (bound_ms, bound_by)) in t.items():
            gathers = (f"; its {sectors_mb:.1f} MB of gathered 32-byte "
                       f"sectors at {sectors_mb / ms / 1e3:.3f} TB/s"
                       if kern == "seg_reduce" else "")
            print(f"seg: {kern} {name}: {ms:.4f} ms (kernel) vs "
                  f"{plain_ms:.4f} ms (plain) vs {lib_ms:.4f} ms (library "
                  f"call); bound {bound_ms:.4f} ms ({bound_by}){gathers}, "
                  f"device time | {smi}")
            if name == "headline C=3":
                stats[kern].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)
    return stats


def _plain_crossings(plain):
    """Route the Schur crossings to the segment kernels or to their plain
    versions."""
    if not plain:
        return contextlib.nullcontext()
    return mock.patch.multiple(
        segmm, seg_reduce_sorted=segmm.seg_reduce_sorted_reference,
        seg_broadcast=segmm.seg_broadcast_reference)


@contextlib.contextmanager
def _held_to_plain(what, stats):
    """Every G/A, reduce and broadcast call of a dense solve also runs its
    plain version on the same inputs and holds the kernel to it: the
    segment kernels bit for bit, G/A within REL_TOL * max|plain|.
    ``stats``: per kernel, the calls held and the largest |kernel - plain|.
    The plain versions synchronize (the reduce reads its longest run on the
    host), so a run under this is neither counted nor checked for syncs."""
    def held(name, kern, plain, exact):
        def call(*args):
            got, ref = kern(*args), plain(*args)
            for g, r in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (got, ref))):
                # a rejected LM step (a failed Cholesky) carries NaN: both
                # must hold it in the same cells, and agree elsewhere
                nan_g, nan_r = g.isnan(), r.isnan()
                same_nan = torch.equal(nan_g, nan_r)
                diff = torch.where(nan_g & nan_r, 0.0,
                                   g.double() - r.double())
                err = float(diff.abs().max()) if g.numel() else 0.0
                scale = float(r.nan_to_num(0.0).abs().max()) \
                    if r.numel() else 0.0
                st = stats.setdefault(name, {"calls": 0, "max_abs_err": 0.0,
                                             "nan_calls": 0})
                st["max_abs_err"] = max(st["max_abs_err"], err)
                st["nan_calls"] += bool(nan_r.any())
                equal = same_nan and (
                    torch.equal(g[~nan_g], r[~nan_r]) if exact
                    else err <= REL_TOL * scale)
                check(equal,
                      f"{what}: {name} call {st['calls']} at shape "
                      f"{tuple(g.shape)}: max |kernel - plain| {err:.3e} "
                      f"(max|plain| {scale:.3e}; NaN cells "
                      f"{int(nan_g.sum())} kernel, {int(nan_r.sum())} plain)")
            stats[name]["calls"] += 1
            return got
        return call

    # schur's own view of segmm: the wrappers count their launches through
    # their module's names, which stay untouched
    view = types.SimpleNamespace(**{
        **vars(segmm),
        "seg_reduce_sorted": held(
            "seg_reduce_sorted", segmm.seg_reduce_sorted,
            segmm.seg_reduce_sorted_reference, True),
        "seg_broadcast": held("seg_broadcast", segmm.seg_broadcast,
                              segmm.seg_broadcast_reference, True)})
    with mock.patch.object(schur, "dense_g_a_window", held(
            "dense_g_a_window", segmm.dense_g_a_window,
            segmm.dense_g_a_window_reference, False)), \
            mock.patch.object(schur, "segmm", view):
        yield


def _held_run(what, fn, counts):
    """Run ``fn`` (a solve) again with every G/A, reduce and broadcast call
    held to its plain version (:func:`_held_to_plain`), and check that the
    calls held are the launches ``counts`` that its counted run made.
    Returns the readings as text."""
    stats = {}
    with _held_to_plain(what, stats):
        fn()
    torch.cuda.synchronize()
    held = {k: v["calls"] for k, v in stats.items()}
    # the CG trip kernel is not held: its plain version is held to it in
    # phase_matrix_free
    want = {k: v for k, v in counts.items() if v and k != "pcg_trip"}
    check(held == want, f"{what}: {held} calls held to the plain versions, "
          f"{want} launches counted")
    return ", ".join(f"{k} {v['calls']} calls (max abs err "
                     f"{v['max_abs_err']:.3e}; {v['nan_calls']} with NaN "
                     f"cells, in the same cells)" for k, v in stats.items())


def _sync_free(fn, solvers=None):
    """Run ``fn`` under PyTorch's sync debug mode. Returns its result and
    the synchronizing calls seen, as {file:line: count}; with ``solvers``
    (a set of (resolved source file, function name)), two such counters:
    the calls made while one of those functions was on the stack, and the
    others (a windowed run's host loop)."""
    inside, other = collections.Counter(), collections.Counter()
    resolved = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = solvers and {
            (resolved.setdefault(f.filename, Path(f.filename).resolve()),
             f.name) for f in traceback.extract_stack()}
        site = f"{filename}:{lineno}"
        (inside if not solvers or frames & solvers else other)[site] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (out, inside, other) if solvers else (out, inside)


def phase_matrix_free(problem, state, smi):
    cfg = dataclasses.replace(bench_problem.bench_config(LM_ITERS),
                              explicit_s="never")
    cg = cfg.cg_max_iters
    reset_launches()
    with trace.recording() as rec:
        (_, info), syncs = _sync_free(
            lambda: ba.solve_ba(problem, state, cfg))
    counts, mv_counts = launch_counts(), matvec_launches()
    check(not syncs, f"matrix_free: synchronizing calls inside solve_ba: "
          f"{dict(syncs)}")
    # per LM iteration: reduces of Hll, bl and back-substitution plus one
    # per CG matvec; the broadcast of schur_rhs; the preconditioner's
    # self-blocks kernel (which gathers Hll^-1 itself); each CG matvec also
    # W^T x, the Hll^-1 step and the pose side (which gathers y itself)
    want = dict(dense_g_a_window=0, seg_reduce_sorted=(3 + cg) * LM_ITERS,
                seg_broadcast=LM_ITERS, hamming_top2=0, hamming_distance=0,
                pcg_trip=cg * LM_ITERS, schur_self_blocks=LM_ITERS)
    check(counts == want, f"matrix_free: launches {counts}, expected {want}")
    want = dict.fromkeys(matvec_launches(), cg * LM_ITERS)
    check(mv_counts == want, f"matrix_free: matvec launches {mv_counts}, "
          f"expected {want}")
    fused, trips = (rec.counters["schur.matvec_fused"],
                    rec.counters["schur.cg_trips"])
    check(fused == trips == cg * LM_ITERS, f"matrix_free: {fused} of "
          f"{trips} matvecs on the fused path")
    cg_fused = rec.counters["schur.cg_fused"]
    pcg_calls = counts["pcg_trip"]
    check(cg_fused == trips == pcg_calls,
          f"matrix_free: {cg_fused} of {trips} CG trips fused, "
          f"{pcg_calls} trip kernel calls")
    precond = rec.counters["schur.precond_fused"]
    check(precond == rec.counters["ba.lm_iterations"] == LM_ITERS,
          f"matrix_free: {precond} preconditioners through the self-blocks "
          f"kernel in {rec.counters['ba.lm_iterations']} LM iterations")
    c0 = float(info["initial_cost"])
    costs = info["costs"].cpu().numpy().astype(np.float64)
    check(np.isfinite(c0) and np.isfinite(costs).all() and costs[-1] < c0,
          f"matrix_free: costs {c0} -> {costs}")
    with _plain_crossings(True):
        _, info_p = ba.solve_ba(problem, state, cfg)
    costs_p = info_p["costs"].cpu().numpy().astype(np.float64)
    check(np.allclose(costs[0], costs_p[0], rtol=1e-3, atol=0.0),
          f"matrix_free: first iteration {costs[0]} vs {costs_p[0]} through "
          f"the plain crossings")
    rel = np.abs(costs - costs_p) / np.abs(costs_p)
    print(f"matrix_free: explicit_s='never', "
          f"{counts['seg_reduce_sorted']} reduce and "
          f"{counts['seg_broadcast']} broadcast launches in {LM_ITERS} "
          f"LM iterations ({3 + cg} and 1 per iteration at {cg} CG "
          f"steps, as worked out from the code), "
          f"{counts['schur_self_blocks']} self-blocks launches (the "
          f"preconditioner's, {precond} counted), "
          + ", ".join(f"{v} {k}" for k, v in mv_counts.items())
          + f" launches ({cg} per iteration each); the fused path took "
          f"{fused} of {trips} matvecs ({100.0 * fused / trips:.1f}%), the "
          f"trip kernel {cg_fused} of {trips} CG trips; no "
          f"G/A launch, no synchronizing call; cost {c0:.6e} -> "
          f"{costs[-1]:.6e}; the plain crossings' trajectory differs by at "
          f"most {rel.max():.3e} (first iteration {rel[0]:.3e}, rtol "
          f"1e-3): {' '.join(f'{c:.6e}' for c in costs)}")
    lam = torch.tensor(cfg.init_lambda, dtype=state.p.dtype,
                       device=state.p.device)
    with precision.full_f32():
        blocks = ba._linearize_ba(problem, state, lam)
    x = torch.randn(blocks.bp.shape, generator=torch.Generator(
        device=state.p.device).manual_seed(0), device=state.p.device)
    steps = bench_problem.matvec_kernel_times(blocks, x)
    print("matrix_free: the fused matvec at the headline's first "
          "linearization, device ms a call (CUDA-graph replay; the plain "
          "reduce on a host clock: it syncs) beside the bound (bytes over "
          "3.35 TB/s) and the plain version's: " + "; ".join(
              f"{k} {v['ms']:.4f} (bound {bound(v['bytes'])[0]:.4f}, "
              f"{v['bytes'] / 1e6:.3f} MB; plain {v['plain_ms']:.4f})"
              for k, v in steps.items()) + f" | {smi}")
    err = bench_problem.matvec_error(blocks, x)
    check(err["fused"] <= 2 * err["plain"] + 2.0**-24,
          f"matrix_free: the fused matvec lies {err['fused']:.3e} from the "
          f"f64 one, the plain {err['plain']:.3e}")
    print(f"matrix_free: f32 matvec against f64 (2-norm, relative): fused "
          f"{err['fused']:.3e}, plain {err['plain']:.3e}")
    _pcg_sync_free(blocks, cfg)
    del blocks, x
    mv_stats = _matvec_cell(smi)
    mv_stats["pcg_trip"] = _pcg_trip_cells(smi)
    mv_stats["schur_self_blocks"] = _self_blocks_cells(smi)
    _solve_witness(cfg, problem.uv.device, smi)
    rates = {"kernel": [], "plain": []}
    final = {}
    for which in ("kernel", "plain", "plain", "kernel"):
        with _plain_crossings(which == "plain"):
            rate, cost = bench_problem.bench_backend(problem, state, cfg=cfg)
        rates[which].append(rate)
        final[which] = cost
    for which in ("kernel", "plain"):
        r = rates[which]
        print(f"matrix_free: {np.median(r):.4f} LM iterations/s through the "
              f"{which} crossings (runs {r[0]:.4f}, {r[1]:.4f}), final cost "
              f"{final[which]:.6e} | {smi}")
    prof = bench_problem.matvec_profile(state.p.device)
    ops = prof.pop("ba_matvec_op_ms")
    print(f"matrix_free: matvec_profile (device time, 50 matvecs each; wall: host clock): "
          + ", ".join(f"{k} {v:.4f}" for k, v in prof.items())
          + " | per op at 300 obs/pose (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ops.items()) + f" | {smi}")
    return {**counts, **mv_counts}, mv_stats


def _matvec_cell(smi):
    """The three matvec kernels on random operands of venice-mf's shape
    (``bench_problem.MATVEC_CELL``: 1,778 poses, Pmax 3,013, so the pose
    side's 1,024-thread blocks; 993,923 landmarks; a strided window view of
    W, ids outside [0, M), padding, fixed cameras and a fixed column), each
    held to its plain version (wt_slots and landmark_step bit for bit,
    pose_side within 1e-5 of the sum of its terms' magnitudes, two runs
    bit-identical), then timed beside its bound and its plain version.
    Returns each kernel's entry stats for the ``kernels`` line."""
    a = bench_problem.matvec_operands(*bench_problem.MATVEC_CELL,
                                      device=torch.device("cuda:0"))
    N, P = a["W"].shape[1:]
    err = bench_problem.matvec_kernel_errors(a)
    check(err["same_bits"] and err["fixed_zero"]
          and err["wt_slots"]["equal"] and err["landmark_step"]["equal"]
          and err["pose_side"]["rel"] <= 1e-5,
          f"matrix_free: the matvec kernels at venice-mf's shape against "
          f"their plain versions: {err}")
    steps = bench_problem.matvec_kernel_times(
        *bench_problem.matvec_operand_blocks(a))
    print(f"matrix_free: the matvec kernels at venice-mf's shape (N {N}, "
          f"Pmax {P}, M {a['hinv'].shape[1]}, strided W, random operands): "
          f"wt_slots and landmark_step equal their plain versions bit for "
          f"bit, pose_side within {err['pose_side']['rel']:.3e} of its "
          f"terms' magnitudes (max abs {err['pose_side']['max_abs_err']:.3e},"
          f" limit 1e-5), two runs bit-identical; device ms a call beside "
          f"the bound and the plain version's: " + "; ".join(
              f"{k} {v['ms']:.4f} (bound {bound(v['bytes'])[0]:.4f}, "
              f"{v['bytes'] / 1e6:.3f} MB; plain {v['plain_ms']:.4f})"
              for k, v in steps.items()) + f" | {smi}")
    out = {}
    for name in ("wt_slots", "landmark_step", "pose_side"):
        bound_ms, bound_by = bound(steps[name]["bytes"])
        out[f"matvec_{name}"] = dict(
            max_abs_err=err[name]["max_abs_err"], ms=steps[name]["ms"],
            plain_ms=steps[name]["plain_ms"], bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None)
    return out


def _pcg_sync_free(blocks, cfg):
    """``schur.pcg`` on ``blocks`` (the headline's first linearization)
    under PyTorch's sync debug mode "error": a host read inside the CG
    loop raises. Every trip through the trip kernel, one call each."""
    rhs = schur.schur_rhs(blocks)
    torch.cuda.synchronize()
    before = segmm.pcg_trip.launches
    with trace.recording() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            cg = schur.pcg(blocks, rhs, cfg.cg_max_iters, cfg.cg_tol)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    trips = rec.counters["schur.cg_trips"]
    check(rec.counters["schur.cg_fused"] == trips == cfg.cg_max_iters
          == segmm.pcg_trip.launches - before,
          f"matrix_free: pcg under sync debug 'error': {dict(rec.counters)}")
    print(f"matrix_free: pcg at the headline's first linearization ran its "
          f"{trips} CG trips through the trip kernel under sync debug mode "
          f"'error' (no host read inside the loop): {int(cg.iterations)} "
          f"live trips, residual {float(cg.residual_norm):.6e}")


def _pcg_trip_cells(smi):
    """The CG trip kernel on random operands at each of
    ``bench_problem.PCG_TRIP_CASES`` (venice-mf's and final-13682-mf's pose
    counts, D = 6 and 15), held to its plain version (x, r, z, p, rz and
    rr within 1e-5 of their largest magnitude, counts equal, a frozen trip
    keeping x, r and rz bit for bit, two runs bit-identical), then timed
    beside its bound and the eager loop body's time. Returns its entry
    stats for the ``kernels`` line (the venice-mf shape's)."""
    rows, stats = [], None
    for N, D, free_cols in bench_problem.PCG_TRIP_CASES:
        a = bench_problem.pcg_trip_operands(N, D, free_cols,
                                            device=torch.device("cuda:0"))
        err = bench_problem.pcg_trip_errors(a)
        worst = max(max(err["rel"].values()), max(err["rel_frozen"].values()))
        check(err["it_equal"] and err["same_bits"] and err["frozen_kept"]
              and err["fixed_zero"] and worst <= 1e-5,
              f"matrix_free: the CG trip kernel at N {N}, D {D} against "
              f"its plain version: {err}")
        t = bench_problem.pcg_trip_times(a)
        bound_ms, bound_by = bound(t["bytes"])
        rows.append(f"N {N} D {D}: {t['ms']:.4f} (bound {bound_ms:.4f}, "
                    f"{t['bytes'] / 1e6:.3f} MB; plain {t['plain_ms']:.4f}; "
                    f"worst gap {worst:.3e})")
        if stats is None:
            stats = dict(max_abs_err=err["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
    print(f"matrix_free: the CG trip kernel on random operands, held to its "
          f"plain version (outputs within 1e-5 of their magnitude, a frozen "
          f"trip bit for bit, two runs bit-identical); device ms a trip "
          f"beside the bound and the eager loop body's: " + "; ".join(rows)
          + f" | {smi}")
    return stats


def _self_blocks_cells(smi):
    """The preconditioner's self-blocks kernel on random operands of
    venice-mf's whole shape (``bench_problem.MATVEC_CELL``: strided W, ids
    outside [0, M), a padding pose) and on a sequential capture's ids at
    final-13682-mf's (``bench_problem.FINAL_CELL``, 8% padding), each held
    to its plain version (within 1e-5 of the sum of its terms' magnitudes,
    both triangles equal, two runs bit-identical), then timed beside its
    bound and the plain composition it replaced (the broadcast kernel and
    eager PyTorch). Returns the venice-mf shape's entry stats for the
    ``kernels`` line."""
    rows, stats = [], None
    for name, (N, P, M), strided, sequential in (
            ("venice-mf", bench_problem.MATVEC_CELL[:3], True, False),
            ("final-13682-mf", bench_problem.FINAL_CELL, False, True)):
        a = bench_problem.self_blocks_operands(
            N, P, M, strided, sequential, device=torch.device("cuda:0"))
        err = bench_problem.self_blocks_errors(a)
        check(err["same_bits"] and err["symmetric"] and err["rel"] <= 1e-5,
              f"matrix_free: the self-blocks kernel at {name}'s shape "
              f"against its plain version: {err}")
        t = bench_problem.self_blocks_times(a)
        # each rounded operation is an instruction of its own (no FMA):
        # half the rate that counts an FMA as two
        bound_ms, bound_by = bound(t["bytes"], t["ops"], ALU_OPS_PER_S / 2)
        rows.append(f"{name} (N {N}, Pmax {P}, M {M}, "
                    f"{'sequential' if sequential else 'random'} ids): "
                    f"{t['ms']:.4f} (bound {bound_ms:.4f} by {bound_by}, "
                    f"{t['bytes'] / 1e6:.3f} MB, {t['ops'] / 1e9:.3f} G "
                    f"operations; with Hll^-1 counted at every slot "
                    f"{bound(t['slot_bytes'])[0]:.4f}; plain "
                    f"{t['plain_ms']:.4f}; within {err['rel']:.3e} of its "
                    f"terms' magnitudes)")
        if stats is None:
            stats = dict(max_abs_err=err["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        del a
        torch.cuda.empty_cache()
    print(f"matrix_free: the preconditioner's self-blocks kernel held to its "
          f"plain version (within 1e-5 of its terms' magnitudes, both "
          f"triangles equal, two runs bit-identical); device ms a call beside "
          f"the bound and the plain composition's: " + "; ".join(rows)
          + f" | {smi}")
    return stats


# seeds of the headline problem the fused matrix-free solve is witnessed on
WITNESS_SEEDS = (0, 1, 2, 3, 4, 5)


def _solve_witness(cfg, dev, smi):
    """The matrix-free headline solve (``cfg``) from each of WITNESS_SEEDS
    five ways: on the card through the fused matvec, self-blocks and CG
    trip, through the plain matvec and self-blocks and through the plain CG
    loop, on the CPU in f32 and,
    the witness, in f64. Each f32 solve's
    distance from the witness: the final state's RMS position difference
    (poses and landmarks, m), the final cost's excess (at the f32 floor,
    where every f32 solve ends far above the f64 one), and the largest
    relative cost difference over the iterations whose f64 cost is at least
    100x its final one (short of that floor); and, at the first
    linearization, 20 steps of PCG's solution's distance from the f64 PCG's
    (relative 2-norm). The fused solve's median distance over the seeds,
    and the plain CG loop's, must each be within 2x the larger of the
    plain matvec's and the CPU f32 solve's medians: f32 rounding, amplified
    by inexact CG steps, parts the f32 solves from the witness; a defect
    of the fused matvec, self-blocks or CG trip would part it further."""
    cpu = torch.device("cpu")
    names = ("fused", "plain", "plain_cg", "cpu_f32")
    plain = {"plain": ((schur, "_takes_fused_matvec"),
                       (segmm, "takes_self_blocks")),
             "plain_cg": ((schur, "_takes_fused_cg"),)}
    rows = {k: [] for k in names}
    for seed in WITNESS_SEEDS:
        problem, state = bench_problem.make_problem(seed=seed, device=dev)
        wide = _to_f64(to_device(problem, cpu), to_device(state, cpu))
        st_w, info_w = ba.solve_ba(*wide, cfg)
        c_w = info_w["costs"].numpy()
        live = c_w >= 100 * c_w[-1]  # iterations short of the f32 floor
        lam = torch.tensor(cfg.init_lambda, dtype=torch.float64)
        with precision.full_f32():
            blocks = ba._linearize_ba(*wide, lam)
            dx_w = schur.pcg(blocks, schur.schur_rhs(blocks),
                             cfg.cg_max_iters, cfg.cg_tol).x
        for name in names:
            pr, st = ((to_device(problem, cpu), to_device(state, cpu))
                      if name == "cpu_f32" else (problem, state))
            with contextlib.ExitStack() as stack:
                for mod, attr in plain.get(name, ()):
                    stack.enter_context(mock.patch.object(
                        mod, attr, return_value=False))
                out, info = ba.solve_ba(pr, st, cfg)
                lam = torch.tensor(cfg.init_lambda, device=st.p.device)
                with precision.full_f32():
                    blocks = ba._linearize_ba(pr, st, lam)
                    dx = schur.pcg(blocks, schur.schur_rhs(blocks),
                                   cfg.cg_max_iters, cfg.cg_tol).x
            c = info["costs"].cpu().double().numpy()
            d = torch.cat([(out.p.cpu().double() - st_w.p).reshape(-1),
                           (out.lm.cpu().double() - st_w.lm).reshape(-1)])
            rows[name].append(dict(
                state=float(d.square().mean().sqrt()),
                cost=float(c[-1] / c_w[-1] - 1),
                path=float(np.max(np.abs(c / c_w - 1)[live])),
                pcg=float((dx.cpu().double() - dx_w).norm() / dx_w.norm())))
    med = {k: {m: float(np.median([r[m] for r in v])) for m in v[0]}
           for k, v in rows.items()}
    for m in ("state", "cost", "path", "pcg"):
        ref = max(med["plain"][m], med["cpu_f32"][m])
        for k in ("fused", "plain_cg"):
            check(med[k][m] <= 2 * ref, f"matrix_free witness: the {k} "
                  f"solve's median {m} distance from the f64 solve "
                  f"{med[k][m]:.3e}, the plain matvec's and the CPU f32 "
                  f"solve's {med['plain'][m]:.3e} and "
                  f"{med['cpu_f32'][m]:.3e}: {rows}")
    print(f"matrix_free witness: the headline solve ({LM_ITERS} LM, "
          f"{cfg.cg_max_iters} CG, matrix-free) from seeds "
          f"{list(WITNESS_SEEDS)} against the same solve in f64 on the CPU; "
          f"medians over the seeds (fused / plain matvec on the card / "
          f"plain CG loop on the card / CPU f32; the fused and the plain CG "
          f"loop each within 2x of the larger of the plain matvec and CPU "
          f"f32): " + "; ".join(
              f"{m} " + " / ".join(f"{med[k][m]:.3e}" for k in names)
              for m in ("state", "cost", "path", "pcg"))
          + " | per seed: " + json.dumps(rows) + f" | {smi}")


def _band_calls(bands):
    """The G/A calls (c0, c1, plo, phi) of a band plan: one per pose run of
    each landmark range."""
    return [(c0, c1, plo, phi) for (c0, c1, ranges) in bands.entries
            for (plo, phi) in ranges]


def _solve_counted(what, fn, iters, want_per_iter):
    """Run ``fn`` (a solve) under sync debug mode with the launch counts
    reset: no synchronizing call outside ``optim/schur.py``'s
    ``torch.linalg`` lines, the launches ``want_per_iter`` (per kernel, per
    LM iteration, as worked out from the code) times ``iters``. Returns
    fn's result and the counts."""
    reset_launches()
    out, syncs = _sync_free(fn)
    counts = launch_counts()
    stray = sorted(set(syncs) - _linalg_sites())
    check(not stray, f"{what}: synchronizing calls outside torch.linalg: "
          f"{ {k: syncs[k] for k in stray} }")
    want = {"hamming_top2": 0, "hamming_distance": 0, "pcg_trip": 0,
            "schur_self_blocks": 0,
            **{k: v * iters for k, v in want_per_iter.items()}}
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    return out, counts


def _pose_gap(a, b):
    """Largest position difference (m) between two states' cameras."""
    return float((a.p.cpu().double() - b.p.cpu().double()).norm(dim=-1).max())


def _ba_errors(out, gt, observed=None):
    """Worst rotation (rad) and position (m) errors of the cameras, and the
    landmark errors (m) of the ``observed`` mask (default: all)."""
    rot = float(so3.rotation_distance(out.q, gt.q).max())
    pos = float((out.p - gt.p).norm(dim=-1).max())
    lm = (out.lm - gt.lm).norm(dim=-1)
    if observed is not None:
        lm = lm[observed]
    return rot, pos, lm.double().cpu().numpy()


def phase_ba_dataset(dev, smi):
    """BA from a VO dataset (BASELINE config 2; tests/test_ba.py's dataset
    and cases), built and solved on the card. The noisy case's bounds are
    gtsam's, and hold on this draw only (2 of port seeds 0-7 meet them,
    tests/ba_noise_draws.py): the card is held by the CPU solve of the
    same draw and by the plain versions of its kernel calls."""
    params = vo_dataset.VoSimParams(**BA_DATASET)
    t0 = time.perf_counter()
    ds = vo_dataset.generate_vo_dataset(
        params, landmarks=vo_dataset.draw_landmarks(params, BA_DATASET_SEED),
        device=dev)
    problem, gt = ba.ba_from_dataset(ds, device=dev)
    build_s = time.perf_counter() - t0
    N, M = gt.q.shape[0], gt.lm.shape[0]
    with tempfile.TemporaryDirectory() as root:
        vo_dataset.save_vo_dataset(ds, root)
        back = vo_dataset.load_vo_dataset(root, device=dev)
        files = len(os.listdir(root))
    again, gt_back = ba.ba_from_dataset(back, device=dev)
    same = [f for f in ("K", "pose_idx", "lm_idx", "uv", "weight", "free_pose")
            if torch.equal(getattr(problem, f), getattr(again, f))]
    same += [f"ell.{f}" for f in ("sigma", "offsets")
             if torch.equal(getattr(problem.ell, f), getattr(again.ell, f))]
    check(len(same) == 8 and all(torch.equal(a, b) for a, b in zip(gt,
                                                                    gt_back)),
          f"ba_dataset: the save/load round trip changed the problem "
          f"(equal: {same})")
    print(f"ba_dataset: {N} poses (of {ds.num_frames} steps), {M} landmarks, "
          f"{int(problem.weight.sum())} observations (slot width "
          f"{problem.lm_idx.shape[0] // N}), built on the card in "
          f"{build_s:.3f} s; save_vo_dataset -> load_vo_dataset through "
          f"{files} files gives the same problem arrays and ground truth")
    observed = torch.zeros(M, dtype=torch.bool, device=dev)
    observed[problem.lm_idx[problem.weight > 0].long()] = True

    rng = np.random.default_rng(11)
    free = problem.free_pose[:, None]
    noise = {k: torch.as_tensor(rng.normal(size=n), device=dev)
             for k, n in (("q", (N, 3)), ("p", (N, 3)), ("lm", (M, 3)))}
    recover = gt._replace(q=so3.quat_boxplus(gt.q, 0.05 * noise["q"] * free),
                          p=gt.p + 0.10 * noise["p"] * free,
                          lm=gt.lm + 0.50 * noise["lm"])
    g = torch.Generator().manual_seed(BA_NOISE_SEED)
    noisy, gt_n = ba.ba_from_dataset(ds, noise_pixels=1.1, generator=g,
                                     with_priors=True, device=dev)
    offline = gt_n._replace(lm=gt_n.lm + torch.tensor(
        [-0.25, 0.20, 0.15], dtype=gt_n.lm.dtype, device=dev))
    cases = (("perturb-and-recover", problem, recover, 25),
             ("noisy offline", noisy, offline, 30))
    for name, pr, init, iters in cases:
        cfg = ba.BAConfig(max_iterations=iters)
        check(ba._use_explicit_s(cfg, N, 6, M, 8, pr.ell, None, pr.bands,
                                 device=dev), f"ba_dataset {name}: not on "
              f"the explicit-S path")
        t0 = time.perf_counter()
        (out, info), counts = _solve_counted(
            f"ba_dataset {name}", lambda: ba.solve_ba(pr, init, cfg), iters,
            dict(dense_g_a_window=1, seg_reduce_sorted=3, seg_broadcast=1,
                 pcg_trip=cg_trips(cfg, init.p.dtype)))
        solve_s = time.perf_counter() - t0
        held = _held_run(f"ba_dataset {name}",
                         lambda: ba.solve_ba(pr, init, cfg), counts)
        t0 = time.perf_counter()
        ba.solve_ba(pr, init, cfg)
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, cpu_info = ba.solve_ba(*(to_device(x, "cpu")
                                      for x in (pr, init)),
                                    cfg)
        cpu_s = time.perf_counter() - t0
        c0, c1 = float(info["initial_cost"]), float(info["final_cost"])
        c1_cpu = float(cpu_info["final_cost"])
        gap = _pose_gap(out, cpu)
        # ba_test.cpp bounds observed landmarks, the offline example all
        rot, pos, lm = _ba_errors(*((out, gt, observed) if pr is problem
                                    else (out, gt_n)))
        check(np.isfinite(c1) and c1 < c0, f"ba_dataset {name}: cost {c0} "
              f"-> {c1}")
        check(gap < 1e-3, f"ba_dataset {name}: card and CPU cameras "
              f"{gap:.3e} m apart (limit 1 mm)")
        if pr is problem:  # ba_test.cpp's bounds
            check(c1 < 1e-6 * c0 and rot < 0.01 and pos < 0.1
                  and lm.max() < 1.0,
                  f"ba_dataset {name}: cost {c0:.3e} -> {c1:.3e}, errors "
                  f"{rot:.4f} rad, {pos:.4f} m, landmarks {lm.max():.3f} m")
            bounds = (f"max rot {rot:.2e} rad (< 0.01), pos {pos:.2e} m "
                      f"(< 0.1), observed landmarks {lm.max():.2e} m (< 1)")
        else:  # gtsam_offline_example.cpp's, as tests/test_ba.py holds them,
            # on this draw: they hold for some draws only
            q85 = float(np.quantile(lm, 0.85))
            check(abs(c1 - c1_cpu) <= 1e-4 * abs(c1_cpu),
                  f"ba_dataset {name}: final cost {c1} vs the CPU's {c1_cpu}")
            check(pos < 0.1 and rot < 0.05 and lm.mean() < 1.5 and q85 < 2.0,
                  f"ba_dataset {name}: errors {pos:.4f} m, {rot:.4f} rad, "
                  f"landmarks mean {lm.mean():.3f} m, 85th pct {q85:.3f} m")
            bounds = (f"on this noise draw (CPU generator seed "
                      f"{BA_NOISE_SEED}; the bounds hold for 2 of port seeds "
                      f"0-7, tests/ba_noise_draws.py) max pos {pos:.4f} m "
                      f"(< 0.1), rot {rot:.4f} rad (< 0.05), landmark error "
                      f"mean {lm.mean():.3f} m (< 1.5), 85th percentile "
                      f"{q85:.3f} m (< 2); final cost "
                      f"{abs(c1 - c1_cpu) / abs(c1_cpu):.2e} from the CPU's "
                      f"(rtol 1e-4)")
        print(f"ba_dataset: {name} ({iters} LM iterations, f64, explicit S):"
              f" {counts['dense_g_a_window']} G/A, "
              f"{counts['seg_reduce_sorted']} reduce, "
              f"{counts['seg_broadcast']} broadcast launches, no sync outside"
              f" torch.linalg; cost {c0:.6e} -> {c1:.6e} (CPU {c1_cpu:.6e}),"
              f" accepted {int(info['accepted'].sum())}/{iters}; {bounds}; "
              f"cameras {gap:.3e} m from the CPU's; held to the plain "
              f"versions: {held}; {solve_s:.3f} s counted"
              f" and in sync debug mode, {again_s:.3f} s again, "
              f"{cpu_s:.3f} s on the CPU | {smi}")


def _batched_checked(what, problems, states, cfg, own, calls_per_iter,
                     trips_per_iter):
    """``solve_ba_batched`` of the windows: counted and sync-free, each
    window held to its own solve (``own``: (costs, accepted) per window),
    then solved again with every kernel call held to its plain version.
    Returns the launch counts and the number of windows equal to their own
    solves bit for bit."""
    B, iters = len(problems), cfg.max_iterations
    (_, info), counts = _solve_counted(
        what, lambda: ba.solve_ba_batched(problems, states, cfg), iters,
        dict(dense_g_a_window=calls_per_iter, seg_reduce_sorted=3,
             seg_broadcast=1, pcg_trip=trips_per_iter))
    costs = info["costs"].cpu()
    accepted = info["accepted"].cpu()
    worst, exact = 0.0, 0
    for b, (c1, a1) in enumerate(own[:B]):
        check(torch.equal(accepted[b], a1), f"{what}: window {b} accepted "
              f"{accepted[b].tolist()}, its own solve {a1.tolist()}")
        rel = float(((costs[b].double() - c1.double()).abs()
                     / c1.double().abs()).max())
        check(rel <= 1e-5, f"{what}: window {b} costs {costs[b].tolist()} "
              f"vs its own solve's {c1.tolist()}")
        worst = max(worst, rel)
        exact += torch.equal(costs[b], c1)
    check(bool((info["final_cost"] < info["initial_cost"]).all()),
          f"{what}: a window's cost did not fall")
    held = _held_run(what, lambda: ba.solve_ba_batched(problems, states, cfg),
                     counts)
    print(f"ba_batched: {what}: per LM iteration "
          f"{counts['dense_g_a_window'] // iters} G/A, "
          f"{counts['seg_reduce_sorted'] // iters} reduce, "
          f"{counts['seg_broadcast'] // iters} broadcast launches, "
          f"{counts['pcg_trip'] // iters} CG trip kernel calls (the code: "
          f"{calls_per_iter}, 3, 1, {trips_per_iter}), no sync outside "
          f"torch.linalg; every "
          f"window's accept flags equal its own solve_ba's, costs within "
          f"{worst:.2e} (rtol 1e-5), {exact}/{B} bit for bit; accepted "
          f"{int(accepted.sum())}/{B * iters}; held to the plain versions: "
          f"{held}")
    return counts, exact


def phase_ba_batched(dev, smi):
    """bench.py's ba_batched: B windows of 50 poses, 2,000 landmarks, 240
    observations per pose in one batch, dense at B = 8 and 32, PCG at 32."""
    t0 = time.perf_counter()
    problems, states = bench_problem.ba_batched_problems(32, device=dev)
    print(f"ba_batched: 32 windows (50 poses, 2,000 landmarks, "
          f"{problems[0].lm_idx.shape[0]} slots each) built in "
          f"{time.perf_counter() - t0:.3f} s")
    cfg_pcg, cfg_dense = bench_problem.batched_configs()
    own = {}
    for name, cfg in (("dense", cfg_dense), ("pcg", cfg_pcg)):
        t0 = time.perf_counter()
        own[name] = [(i["costs"].cpu(), i["accepted"].cpu()) for i in (
            ba.solve_ba(p, s, cfg)[1] for p, s in zip(problems, states))]
        print(f"ba_batched: 32 own solve_ba runs ({name}) in "
              f"{time.perf_counter() - t0:.3f} s")
    # PCG on the card takes explicit S with each window's band plan, one
    # pcg a window
    pcg_calls = sum(len(_band_calls(p.bands)) for p in problems)
    pcg_trips = 32 * cg_trips(cfg_pcg, states[0].p.dtype)
    counts = {}
    for what, n, cfg, calls, trips in (
            ("B = 8 dense", 8, cfg_dense, 8, 0),
            ("B = 32 dense", 32, cfg_dense, 32, 0),
            ("B = 32 PCG", 32, cfg_pcg, pcg_calls, pcg_trips)):
        counts[what], _ = _batched_checked(
            what, problems[:n], states[:n], cfg,
            own["dense" if cfg is cfg_dense else "pcg"], calls, trips)
    t0 = time.perf_counter()
    rates = bench_problem.bench_ba_batched(problems, states)
    print(f"ba_batched: rates (LM iterations/s, aggregate; "
          f"{time.perf_counter() - t0:.3f} s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in rates.items()) + f" | {smi}")
    return counts


def phase_ba_large(dev, smi):
    """bench.py's ba_large end to end: 400 poses, 100,000 landmarks, 1,500
    observations per pose, 5 LM iterations, explicit S with its band plan;
    every kernel call of the solve held to its plain version."""
    t0 = time.perf_counter()
    problem, state = bench_problem.ba_large_problem(device=dev)
    calls = _band_calls(problem.bands)
    N, M = problem.num_poses, state.lm.shape[0]
    cfg = bench_problem.bench_config(BA_LARGE_ITERS)
    check(ba._use_explicit_s(cfg, N, 6, M, 4, problem.ell, None,
                             problem.bands, device=dev),
          "ba_large does not take the explicit-S path")
    print(f"ba_large: {N} poses, {M} landmarks, {problem.lm_idx.shape[0]} "
          f"slots, {len(problem.bands.entries)} band entries ({len(calls)} "
          f"G/A calls) built in {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    (_, info), counts = _solve_counted(
        "ba_large", lambda: ba.solve_ba(problem, state, cfg), BA_LARGE_ITERS,
        dict(dense_g_a_window=len(calls), seg_reduce_sorted=3, seg_broadcast=1,
             pcg_trip=cg_trips(cfg, state.p.dtype)))
    peak = torch.cuda.max_memory_allocated(dev)
    c0 = float(info["initial_cost"])
    costs = info["costs"].cpu().numpy().astype(np.float64)
    check(np.isfinite(c0) and np.isfinite(costs).all() and costs[-1] < c0,
          f"ba_large: costs {c0} -> {costs}")
    held = _held_run("ba_large", lambda: ba.solve_ba(problem, state, cfg),
                     counts)
    first = dataclasses.replace(cfg, max_iterations=1)
    _, info_p = _solve(problem, state, first, plain=True)
    c_plain = float(info_p["costs"][0])
    rel = abs(costs[0] - c_plain) / abs(c_plain)
    check(rel <= 1e-3, f"ba_large: first iteration {costs[0]} vs {c_plain} "
          f"with the plain G/A")
    rate = bench_problem.bench_ba_large(problem, state)
    print(f"ba_large: explicit S, per LM iteration {len(calls)} G/A, 3 "
          f"reduce, 1 broadcast launches and "
          f"{counts['pcg_trip'] // BA_LARGE_ITERS} CG trip kernel calls (as "
          f"the code works them out), no "
          f"sync outside torch.linalg; cost {c0:.6e} -> {costs[-1]:.6e}, "
          f"accepted {int(info['accepted'].sum())}/{BA_LARGE_ITERS}; first "
          f"iteration {rel:.3e} from the plain-G/A solve (rtol 1e-3); held "
          f"to the plain versions: {held}; peak "
          f"allocation {peak / 2**30:.3f} GiB; "
          f"{rate['ba_lm_iterations_per_s_100k_landmarks']:.4f} LM "
          f"iterations/s, final cost {rate['ba_100k_final_cost']:.6e} | "
          f"{smi}")
    lam = torch.tensor(cfg.init_lambda, dtype=state.p.dtype, device=dev)
    with precision.full_f32():
        blocks = ba._linearize_ba(problem, state, lam)
    _g_a_timing("ba_large: one LM iteration's", blocks.W, blocks.ell,
                blocks.Hll_inv, calls, reps=5)
    return counts


def _ate(gt, est):
    t = torch.arange(gt.q.shape[0], dtype=torch.float64)
    truth = Trajectory(t, SE3(gt.q.double().cpu(), gt.p.double().cpu()))
    traj = Trajectory(t, SE3(est.q.double().cpu(), est.p.double().cpu()))
    return float(absolute_trajectory_error(truth, traj)[0])


def _linalg_sites(*modules):
    """file:line of every ``torch.linalg`` call in ``modules`` (default
    ``optim/schur.py``: the dense solves' factorizations, the only
    synchronizing calls a VIO solve may make)."""
    sites = set()
    for m in modules or (schur,):
        src = Path(inspect.getsourcefile(m))
        sites |= {f"{src}:{i}" for i, line in
                  enumerate(src.read_text().splitlines(), 1)
                  if "torch.linalg." in line}
    return sites


def phase_vio(dev, smi):
    problem, gt, init = bench_problem.make_vio_problem(device=dev)
    N, M = gt.q.shape[0], gt.lm.shape[0]
    K = problem.lm_idx.shape[0]
    it = bench_problem.vio_config().max_iterations
    cg = bench_problem.vio_config().cg_max_iters
    ate0 = _ate(gt, init)
    aligned = K % 4 == 0 and problem.lm_idx.data_ptr() % 16 == 0
    print(f"vio: bench_vio's problem built by the port from seeds 2, 3, 4 "
          f"(its own draws, not the JAX package's): {N} keyframes, {M} "
          f"landmarks, {K} observation slots (K % 4 = {K % 4}: the broadcast "
          f"takes its {'16-byte' if aligned else 'scalar'} path), f32; ATE "
          f"of the start {ate0:.6f} m")
    linalg_sites = _linalg_sites()
    # per LM iteration, dense: reduces of Hll, bl and back-substitution,
    # schur_rhs's broadcast, one G/A build; PCG: as the matrix-free BA
    # path, with cg_max_iters matvecs on the fused path and as many CG
    # trip kernel calls (D = 15), and the preconditioner's self-blocks
    # kernel (f32)
    trips = cg_trips(bench_problem.vio_config("pcg"), init.p.dtype)
    fused = int(init.p.dtype == torch.float32)
    wants = {
        "auto": (dict(dense_g_a_window=it, seg_reduce_sorted=3 * it,
                      seg_broadcast=it, hamming_top2=0, hamming_distance=0,
                      pcg_trip=0, schur_self_blocks=0),
                 dict.fromkeys(matvec_launches(), 0)),
        "pcg": (dict(dense_g_a_window=0, seg_reduce_sorted=(3 + cg) * it,
                     seg_broadcast=(2 - fused) * it, hamming_top2=0,
                     hamming_distance=0, pcg_trip=trips * it,
                     schur_self_blocks=fused * it),
                dict.fromkeys(matvec_launches(), cg * it)),
    }
    cpu = torch.device("cpu")
    problem_cpu, init_cpu = to_device(problem, cpu), to_device(init, cpu)
    out = {}
    for solver, (want, mv_want) in wants.items():
        cfg = bench_problem.vio_config(solver)
        reset_launches()
        (est, info), syncs = _sync_free(
            lambda: vio.solve_vio(problem, init, cfg))
        counts, mv_counts = launch_counts(), matvec_launches()
        check(counts == want and mv_counts == mv_want,
              f"vio {solver}: launches {counts} and {mv_counts}, expected "
              f"{want} and {mv_want}")
        stray = sorted(set(syncs) - linalg_sites)
        check(not stray, f"vio {solver}: synchronizing calls outside "
              f"torch.linalg: {stray}")
        c0 = float(info["initial_cost"])
        cost = float(info["final_cost"])
        ate = _ate(gt, est)
        check(np.isfinite(cost) and cost < c0 and ate < ate0,
              f"vio {solver}: cost {c0} -> {cost}, ATE {ate0} -> {ate}")
        est_cpu, info_cpu = vio.solve_vio(problem_cpu, init_cpu, cfg)
        cost_cpu = float(info_cpu["final_cost"])
        dp = float((est.p.cpu() - est_cpu.p).abs().max())
        check(abs(cost - cost_cpu) <= 1e-2 * abs(cost_cpu) and dp <= 1e-2,
              f"vio {solver}: card final cost {cost} vs CPU {cost_cpu}, "
              f"keyframe positions differ by {dp} m")
        rates = []
        for _ in range(2):
            rate, _ = bench_problem.bench_vio(problem, init, solver)
            rates.append(rate)
        listed = ", ".join(f"{Path(k).name}:{k.rsplit(':', 1)[1]} x{v}"
                           for k, v in sorted(syncs.items())) or "none"
        print(f"vio {solver}: {counts['dense_g_a_window']} G/A, "
              f"{counts['seg_reduce_sorted']} reduce and "
              f"{counts['seg_broadcast']} broadcast and "
              f"{counts['schur_self_blocks']} self-blocks launches, "
              f"{mv_counts['matvec_pose_side']} of each "
              f"matvec kernel, {counts['pcg_trip']} CG trip kernel calls "
              f"in {it} LM iterations (as worked out from "
              f"the code); synchronizing calls: {listed}; cost {c0:.6e} -> "
              f"{cost:.6e} (CPU, plain versions: {cost_cpu:.6e}, ATE "
              f"{_ate(gt, est_cpu):.6f} m; keyframe positions within "
              f"{dp:.3e} m); ATE {ate0:.6f} -> {ate:.6f} m; "
              f"{np.median(rates):.3f} keyframes/s (runs "
              f"{', '.join(f'{r:.3f}' for r in rates)}) | {smi}")
        out[solver] = counts
    return out


def _euroc_build(root, params, device):
    """``build_euroc_vio_problem`` on ``device`` (f32) and its seconds, the
    device synchronized."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    built = euroc_vio.build_euroc_vio_problem(root, params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return built, time.perf_counter() - t0


def phase_euroc(dev, smi):
    params = euroc_vio.EurocVIOParams()
    cfg = euroc_vio.default_vio_config(params)
    it = cfg.max_iterations
    with tempfile.TemporaryDirectory(prefix="euroc_") as root:
        t0 = time.perf_counter()
        euroc_sim.generate_euroc_sequence(root, EUROC_SIM, seed=EUROC_SEED,
                                          device=dev)
        gen_s = time.perf_counter() - t0
        (problem, init, gt_traj, kf_times), build_s = _euroc_build(
            root, params, dev)
        N, M = init.q.shape[0], init.lm.shape[0]
        check(init.q.dtype == torch.float32 and kf_times.dtype ==
              torch.float64, "euroc: the problem is not f32 or the times "
              "are not f64")
        # per LM iteration on the dense path (N * 15 <= dense_max_pose_dim
        # and M <= dense_max_landmarks): one G/A build, the reduces of Hll,
        # bl and back-substitution, schur_rhs's broadcast
        want = dict(dense_g_a_window=it, seg_reduce_sorted=3 * it,
                    seg_broadcast=it, hamming_top2=0, hamming_distance=0,
                    pcg_trip=0, schur_self_blocks=0)
        reset_launches()
        (state, info), syncs = _sync_free(
            lambda: vio.solve_vio(problem, init, cfg))
        counts = launch_counts()
        check(counts == want, f"euroc: launches {counts} in {it} LM "
              f"iterations, expected {want}")
        stray = sorted(set(syncs) - _linalg_sites())
        check(not stray, f"euroc: synchronizing calls inside solve_vio "
              f"outside torch.linalg: {stray}")
        rep = euroc_vio.euroc_report(gt_traj, kf_times, init, state, info)
        c0, cost = rep["initial_cost"], rep["final_cost"]
        ate, ate0 = rep["ate_rmse"], rep["ate_rmse_deadreckon"]
        check(np.isfinite(cost) and cost < c0,
              f"euroc: cost {c0} -> {cost}")
        check(ate < ate0 and ate < EUROC_ATE_BOUND_M,
              f"euroc: ATE {ate} m (dead reckoning {ate0} m, bound "
              f"{EUROC_ATE_BOUND_M} m)")
        cpu = torch.device("cpu")
        (problem_c, init_c, gt_c, kf_c), build_cpu_s = _euroc_build(
            root, params, cpu)
        est_c, info_c = vio.solve_vio(problem_c, init_c, cfg)
        rep_c = euroc_vio.euroc_report(gt_c, kf_c, init_c, est_c, info_c)
        dp = float((state.p.cpu() - est_c.p).abs().max())
        check(abs(cost - rep_c["final_cost"]) <= 1e-4 * abs(rep_c["final_cost"])
              and dp <= 1e-3, f"euroc: card final cost {cost} vs CPU "
              f"{rep_c['final_cost']}, keyframe positions differ by {dp} m")
        times = []
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, info_t = vio.solve_vio(problem, init, cfg)
            float(info_t["final_cost"])
            times.append(time.perf_counter() - t0)
    listed = ", ".join(f"{Path(k).name}:{k.rsplit(':', 1)[1]} x{v}"
                       for k, v in sorted(syncs.items())) or "none"
    print(f"euroc: bench.py's euroc sequence (16 s, 200 Hz IMU, 5 Hz camera, "
          f"200 landmarks, seed {EUROC_SEED}) written by the port in "
          f"{gen_s:.3f} s; {N} keyframes, {M} landmarks, "
          f"{int((problem.obs_weight > 0).sum())} live observations; built "
          f"in {build_s:.3f} s on the card ({build_cpu_s:.3f} s on the CPU), "
          f"f32 | {smi}")
    print(f"euroc: {counts['dense_g_a_window']} G/A, "
          f"{counts['seg_reduce_sorted']} reduce and "
          f"{counts['seg_broadcast']} broadcast launches in {it} LM "
          f"iterations (dense path, as worked out from the code); "
          f"synchronizing calls: {listed}; cost {c0:.6e} -> {cost:.6e} (CPU, "
          f"plain versions: {rep_c['final_cost']:.6e}, relative difference "
          f"{abs(cost / rep_c['final_cost'] - 1):.3e} (rtol 1e-4), ATE "
          f"{rep_c['ate_rmse']:.6f} m; keyframe positions within {dp:.3e} m, "
          f"bound 1e-3 m)")
    print(f"euroc: ATE {ate:.6f} m (dead reckoning {ate0:.6f} m, bound "
          f"{EUROC_ATE_BOUND_M} m), RPE {rep['rpe_trans_rmse']:.6f} m "
          f"{rep['rpe_rot_rmse']:.6f} rad; solve "
          f"{N / np.median(times):.3f} keyframes/s (runs "
          f"{', '.join(f'{N / t:.3f}' for t in times)}), build + solve "
          f"{N / (build_s + np.median(times)):.3f} keyframes/s | {smi}")
    return counts


def _solver_entry_points():
    """(file, name) of the solver entry points a windowed run calls: a
    synchronizing call made while one of them is on the stack fails."""
    return {(Path(inspect.getsourcefile(m)).resolve(), name)
            for m, names in ((vio, ("solve_vio", "vio_marginalize_device",
                                    "vio_reduced_hessian")),
                             (ba, ("solve_ba", "ba_reduced_hessian")))
            for name in names}


def _sites(counter):
    return ", ".join(f"{Path(k).name} x{v}"
                     for k, v in sorted(counter.items())) or "none"


def _windowed_launches(iters, n_marg, trips_per_iter=0):
    """Per dense (or explicit-S) LM iteration: 1 G/A build, the reduces of
    Hll, bl and back-substitution, schur_rhs's broadcast, and
    ``trips_per_iter`` CG trip kernel calls; per Schur complement
    (``vio_marginalize_device``, ``vio_reduced_hessian`` or
    ``ba_reduced_hessian``): 1 G/A, the reduces of Hll and bl, 1
    broadcast."""
    return dict(dense_g_a_window=iters + n_marg,
                seg_reduce_sorted=3 * iters + 2 * n_marg,
                seg_broadcast=iters + n_marg, hamming_top2=0,
                hamming_distance=0, pcg_trip=trips_per_iter * iters,
                schur_self_blocks=0)


def _solver_checked(what, fn, n_marg_of, sync_debug=True, trips_per_iter=0):
    """Drive ``fn`` (a windowed solve returning its report last) with the
    launch counts set to 0 and, with ``sync_debug``, PyTorch's sync debug
    mode on (it slows each LM iteration by a third to a half); check the
    launches against the code's (``n_marg_of(report)`` complements,
    ``trips_per_iter`` CG trip kernel calls an LM iteration) and that no
    solver entry point synchronized outside ``torch.linalg``."""
    reset_launches()
    if sync_debug:
        out, inside, host = _sync_free(fn, _solver_entry_points())
    else:
        out, inside, host = fn(), None, None
    counts = launch_counts()
    rep = out[-1]
    iters = sum(rep["window_iterations"])
    want = _windowed_launches(iters, n_marg_of(rep), trips_per_iter)
    check(counts == want, f"{what}: launches {counts} in {iters} LM "
          f"iterations, expected {want}")
    stray = sorted(set(inside or ()) - _linalg_sites())
    check(not stray, f"{what}: synchronizing calls inside the solvers "
          f"outside torch.linalg: {stray}")
    return out, counts, inside, host


def _vio_marg_count(rep):
    """Complements a windowed VIO run made: every solved window but the
    last of a pass (marginalization mode), plus the host fallbacks."""
    if rep["mode"] != "marginalize":
        return 0
    solved = len(rep["window_iterations"])
    return solved - solved // rep["num_windows"] + rep["marg_host_fallbacks"]


def _write_sequence(root, sim, name):
    """Write ``sim`` with ``bench_windowed.write_sequence`` (the port's
    generator on a CPU ``torch.Generator``: the directory a machine without
    a card writes too); its hashes must be those of the directory the JAX
    package's ATE was read on."""
    gen_s, hashes = bench_windowed.write_sequence(root, sim)
    hashes = tuple(hashes[f] for f in ("imu0/data.csv", "cam0/tracks.csv"))
    print(f"{name}: sequence written in {gen_s:.3f} s (CPU generator, seed "
          f"{bench_windowed.SEED}): sha256 imu0/data.csv {hashes[0]}, "
          f"cam0/tracks.csv {hashes[1]}")
    check(hashes == SEQUENCE_SHA256[name], f"{name}: the sequence is not "
          f"the directory the JAX package's ATE was read on (sha256 "
          f"{SEQUENCE_SHA256[name]})")
    return gen_s


def _windowed_run(root, wp, device, stop=None):
    return windowed_vio.run_euroc_vio_windowed(
        root, euroc_vio.EurocVIOParams(), wp, device=device,
        stop_after_windows=stop)


def _check_dense(what, rep):
    cfg = euroc_vio.default_vio_config(euroc_vio.EurocVIOParams())
    check(ba._use_dense_schur(cfg, rep["window"], 15, 6,
                              rep["num_landmarks_padded"], 4, None),
          f"{what}: the windows do not take the dense path "
          f"(W {rep['window']}, M {rep['num_landmarks_padded']})")


def _rates(rep):
    return (f"solve {rep['solve_keyframes_per_s']:.3f} keyframes/s, "
            f"sequence {rep['sequence_keyframes_per_s']:.3f} keyframes/s, "
            f"solve {rep['solve_seconds']:.3f} s, marginalization "
            f"{rep['marginalization_seconds']:.3f} s, "
            f"marg_host_fallbacks {rep['marg_host_fallbacks']}")


def _card_vs_cpu(what, root, wp, card):
    """``card``, the (estimate, report) of the first 2 windows of ``wp`` on
    the card, against the same on this machine's CPU through the plain
    versions: the same Hessian dtype, no host fallback, window costs within
    rtol 1e-4 and keyframe positions within 1 mm."""
    est, rep = card
    t0 = time.perf_counter()
    est_c, rep_c = _windowed_run(root, wp, torch.device("cpu"), 2)
    cpu_s = time.perf_counter() - t0
    check(rep["hessian_dtype"] == rep_c["hessian_dtype"],
          f"{what}: hessian_dtype {rep['hessian_dtype']} on the card, "
          f"{rep_c['hessian_dtype']} on the CPU")
    check(rep["marg_host_fallbacks"] == 0, f"{what}: "
          f"{rep['marg_host_fallbacks']} complements of the first 2 windows "
          f"fell back to the host")
    c_card = np.asarray(rep["window_final_costs"])
    c_cpu = np.asarray(rep_c["window_final_costs"])
    rel = float(np.abs(c_card / c_cpu - 1).max())
    dp = float((est.poses.t - est_c.poses.t).abs().max())
    check(rel <= 1e-4 and dp <= 1e-3, f"{what}: first 2 windows' costs "
          f"{c_card} on the card vs {c_cpu} on the CPU, positions within "
          f"{dp} m")
    print(f"{what}: first 2 windows, card vs this machine's CPU (plain "
          f"versions, hessian_dtype {rep['hessian_dtype']}, {cpu_s:.3f} s): "
          f"costs {' '.join(f'{c:.6e}' for c in c_card)} vs "
          f"{' '.join(f'{c:.6e}' for c in c_cpu)}, relative difference "
          f"{rel:.3e} (rtol 1e-4), positions within {dp:.3e} m (bound 1e-3 "
          f"m); iterations {rep['window_iterations']} vs "
          f"{rep_c['window_iterations']}")


def phase_windowed(dev, smi):
    wp, wf = bench_windowed.LONG_WINDOWS, bench_windowed.LONG_FREEZE
    with tempfile.TemporaryDirectory(prefix="euroc_long_") as root:
        _write_sequence(root, WINDOWED_SIM, "windowed")
        # the rates come from runs without sync debug mode
        (_, rep), counts, _, _ = _solver_checked(
            "windowed", lambda: _windowed_run(root, wp, dev), _vio_marg_count,
            sync_debug=False)
        (_, rep_f), counts_f, _, _ = _solver_checked(
            "windowed freeze", lambda: _windowed_run(root, wf, dev),
            _vio_marg_count, sync_debug=False)
        # sync debug mode over the first 2 windows, which are also held
        # against the CPU
        two, counts2, inside, host = _solver_checked(
            "windowed 2 windows", lambda: _windowed_run(root, wp, dev, 2),
            _vio_marg_count)
        _card_vs_cpu("windowed", root, wp, two)
    for what, r in (("2-pass", rep), ("freeze", rep_f)):
        _check_dense(f"windowed {what}", r)
        costs = np.asarray(r["window_final_costs"])
        check(np.isfinite(costs).all(), f"windowed {what}: costs {costs}")
    check(rep["marg_host_fallbacks"] == 0,
          f"windowed: {rep['marg_host_fallbacks']} complements fell back to "
          f"the host")
    ate, ate_f = rep["ate_rmse"], rep_f["ate_rmse"]
    check(ate < ate_f and ate < WINDOWED_ATE_BOUND_M,
          f"windowed: 2-pass ATE {ate} m, freeze {ate_f} m, bound "
          f"{WINDOWED_ATE_BOUND_M} m")
    iters = sum(rep["window_iterations"])
    print(f"windowed: bench.py's euroc_long in full: {rep['num_keyframes']} "
          f"keyframes, {rep['num_windows']} windows of {rep['window']} "
          f"(overlap {rep['overlap']}), 2 passes, f32 (hessian_dtype "
          f"{rep['hessian_dtype']}), {rep['num_landmarks_padded']} landmark "
          f"slots a window | {smi}")
    print(f"windowed: {counts['dense_g_a_window']} G/A, "
          f"{counts['seg_reduce_sorted']} reduce and "
          f"{counts['seg_broadcast']} broadcast launches in "
          f"{iters} LM iterations and {_vio_marg_count(rep)} device "
          f"complements (as worked out from the code; freeze: "
          f"{counts_f['dense_g_a_window']}/{counts_f['seg_reduce_sorted']}/"
          f"{counts_f['seg_broadcast']} in "
          f"{sum(rep_f['window_iterations'])} iterations; the first 2 "
          f"windows: {counts2['dense_g_a_window']}/"
          f"{counts2['seg_reduce_sorted']}/"
          f"{counts2['seg_broadcast']} in "
          f"{sum(two[1]['window_iterations'])} iterations and "
          f"{_vio_marg_count(two[1])} complements); "
          f"synchronizing calls over those 2 windows (sync debug mode) "
          f"inside the solvers: {_sites(inside)}; in the host loop: "
          f"{_sites(host)}")
    jax = JAX_WINDOWED_ATE
    print(f"windowed: ATE 2-pass {ate:.6f} m, freeze {ate_f:.6f} m (bound "
          f"{WINDOWED_ATE_BOUND_M} m; the JAX package on this directory: "
          f"{jax['marginalize_2pass']} and {jax['freeze']} m), RPE "
          f"{rep['rpe_trans_rmse']:.6f} m; 2-pass {_rates(rep)}; freeze "
          f"{_rates(rep_f)} | {smi}")
    return counts


def phase_mh01_scale(dev, smi):
    wp = bench_windowed.MH01_WINDOWS
    with tempfile.TemporaryDirectory(prefix="euroc_mh01_") as root:
        _write_sequence(root, MH01_SIM, "mh01_scale")
        (_, rep), counts, inside, host = _solver_checked(
            "mh01_scale", lambda: _windowed_run(root, wp, dev),
            _vio_marg_count)
        two, counts2, _, _ = _solver_checked(
            "mh01_scale 2 windows", lambda: _windowed_run(root, wp, dev, 2),
            _vio_marg_count, sync_debug=False)
        _card_vs_cpu("mh01_scale", root, wp, two)
    _check_dense("mh01_scale", rep)
    costs = np.asarray(rep["window_final_costs"])
    check(np.isfinite(costs).all(), f"mh01_scale: costs {costs}")
    check(rep["hessian_dtype"] == "float64", f"mh01_scale: hessian_dtype "
          f"{rep['hessian_dtype']}, the stiffness gate did not widen")
    check(rep["marg_host_fallbacks"] == 0, f"mh01_scale: "
          f"{rep['marg_host_fallbacks']} complements fell back to the host")
    ate = rep["ate_rmse"]
    check(ate <= 1.5 * JAX_MH01_ATE + 1e-3, f"mh01_scale: ATE {ate} m, the "
          f"JAX package's {JAX_MH01_ATE} m on this directory")
    print(f"mh01_scale: bench.py's euroc_mh01_scale at its widths, cut to "
          f"{MH01_SIM.duration:g} s: {rep['num_keyframes']} keyframes, "
          f"{rep['num_windows']} windows of {rep['window']} (overlap "
          f"{rep['overlap']}), f32 with hessian_dtype "
          f"{rep['hessian_dtype']}; {counts['dense_g_a_window']} G/A, "
          f"{counts['seg_reduce_sorted']} reduce and "
          f"{counts['seg_broadcast']} broadcast launches in "
          f"{sum(rep['window_iterations'])} LM "
          f"iterations and {_vio_marg_count(rep)} device complements (as "
          f"worked out from the code; the first 2 windows: "
          f"{counts2['dense_g_a_window']}/{counts2['seg_reduce_sorted']}/"
          f"{counts2['seg_broadcast']} in "
          f"{sum(two[1]['window_iterations'])} iterations and "
          f"{_vio_marg_count(two[1])} complements); synchronizing calls "
          f"inside the solvers: {_sites(inside)}; in the host loop: "
          f"{_sites(host)}")
    print(f"mh01_scale: ATE {ate:.6f} m (the JAX package on this directory: "
          f"{JAX_MH01_ATE} m; bound 1.5x + 1 mm), RPE "
          f"{rep['rpe_trans_rmse']:.6f} m; under sync debug mode: "
          f"{_rates(rep)} | {smi}")
    return counts


def _wba_run(c, frames, wp, cfg, device):
    def bank(cls, fields):
        return cls(**{k: torch.as_tensor(v).to(device)
                      for k, v in fields.items()})

    return windowed_ba.solve_ba_windowed(
        c["K"], c["tracks"], frames, c["q_init"], c["p_init"],
        between=bank(BetweenBank, c["between"]),
        priors=bank(PriorBank, c["priors"]), wparams=wp, cfg=cfg,
        device=device)


def phase_windowed_ba(dev, smi):
    c = bench_problem.windowed_ba_circle()
    N = c["num_frames"]
    wp = windowed_ba.WindowedBAParams(window=60, overlap=10)
    cfg = ba.BAConfig(max_iterations=40, cg_max_iters=150, huber_delta=3.0)
    # explicit-S PCG in f32: every CG trip through the trip kernel
    trips = cg_trips(cfg, torch.float32)
    (q, p, rep), counts, inside, host = _solver_checked(
        "windowed_ba", lambda: _wba_run(c, N, wp, cfg, dev),
        lambda r: r["num_windows"] - 1, trips_per_iter=trips)
    pos = float(np.linalg.norm(p - c["p_gt"], axis=-1).max())
    rot = float(so3.rotation_distance(torch.as_tensor(q),
                                      torch.as_tensor(c["q_gt"])).max())
    costs = np.asarray(rep["window_final_costs"])
    check(np.isfinite(costs).all() and pos < WBA_POS_BOUND_M
          and rot < WBA_ROT_BOUND_RAD, f"windowed_ba: costs {costs}, "
          f"position error {pos} m, rotation error {rot} rad")
    # card against CPU: the first two windows' frames; the CPU takes the
    # card's explicit-S PCG ("auto" picks it only on a CUDA device)
    two = wp.window + (wp.window - wp.overlap)
    (_, p2, rep2), _, _, _ = _solver_checked(
        "windowed_ba 2 windows", lambda: _wba_run(c, two, wp, cfg, dev),
        lambda r: r["num_windows"] - 1, trips_per_iter=trips)
    t0 = time.perf_counter()
    _, p_c, rep_c = _wba_run(c, two, wp, dataclasses.replace(
        cfg, explicit_s="always"), torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    c_card = np.asarray(rep2["window_final_costs"])
    c_cpu = np.asarray(rep_c["window_final_costs"])
    rel = float(np.abs(c_card / c_cpu - 1).max())
    dp = float(np.abs(p2 - p_c).max())
    check(rel <= 1e-4 and dp <= 1e-3, f"windowed_ba: first 2 windows' costs "
          f"{c_card} on the card vs {c_cpu} on the CPU, positions within "
          f"{dp} m")
    iters = sum(rep["window_iterations"])
    print(f"windowed_ba: the JAX package's test circle (VoSimParams("
          f"nb_landmarks=120, steps=2000, fx=fy=200, hz=10), numpy seeds 0 "
          f"and 1): {N} frames, {len(c['tracks'])} observations, "
          f"{rep['num_windows']} windows of {rep['window']} (overlap "
          f"{rep['overlap']}), f32; {counts['dense_g_a_window']} G/A, "
          f"{counts['seg_reduce_sorted']} reduce and "
          f"{counts['seg_broadcast']} broadcast launches and "
          f"{counts['pcg_trip']} CG trip kernel "
          f"calls in {iters} LM iterations and "
          f"{rep['num_windows'] - 1} reduced Hessians (explicit-S PCG, as "
          f"worked out from the code); synchronizing calls inside the "
          f"solvers: {_sites(inside)}; in the host loop: {_sites(host)}")
    print(f"windowed_ba: position error max {pos:.6f} m (bound "
          f"{WBA_POS_BOUND_M}), rotation error max {rot:.6f} rad (bound "
          f"{WBA_ROT_BOUND_RAD}); under sync debug mode: solve "
          f"{rep['solve_seconds']:.3f} s "
          f"({N * rep['passes'] / rep['solve_seconds']:.3f} frames/s), "
          f"marginalization {rep['marginalization_seconds']:.3f} s; first 2 "
          f"windows card vs CPU ({cpu_s:.3f} s): costs "
          f"{' '.join(f'{x:.6e}' for x in c_card)} vs "
          f"{' '.join(f'{x:.6e}' for x in c_cpu)}, relative {rel:.3e} (rtol "
          f"1e-4), positions within {dp:.3e} m (bound 1e-3 m) | {smi}")
    return counts


def _lidar_entry_points():
    """(file, name) of the matchers and the pose-graph solve."""
    return {(Path(inspect.getsourcefile(inspect.unwrap(fn))).resolve(),
             fn.__name__)
            for fn in (icp_match, gicp_match, ndt_match, solve_pose_graph)}


def _lidar_checked(what, fn):
    """Run ``fn`` under sync debug mode with the kernels' launch counts set
    to 0: no synchronizing call while a matcher or the pose-graph solve is
    on the stack outside ``torch.linalg``, and none of the package's five
    kernels launched. Returns (result, sites inside, sites outside)."""
    reset_launches()
    out, inside, host = _sync_free(fn, _lidar_entry_points())
    counts = launch_counts()
    check(not any(counts.values()), f"{what}: the lidar path launched "
          f"{counts}")
    stray = sorted(set(inside) - _linalg_sites(*LIDAR_MODULES))
    check(not stray, f"{what}: synchronizing calls inside the matchers "
          f"outside torch.linalg: {stray}")
    return out, inside, host


def _lidar_data(what, key, *arrays):
    got = tuple(bench_lidar.sha256(a) for a in arrays)
    print(f"{what}: data sha256 {' '.join(got)}")
    check(got == bench_lidar.SHA256[key], f"{what}: the data is not the "
          f"arrays the JAX package's anchors were read on "
          f"({bench_lidar.SHA256[key]})")


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _t_diff(T, T_true):
    """||T_est - T_true||_F, the reference's registration error."""
    return float(torch.linalg.matrix_norm(
        SE3(*(x.double().cpu() for x in T)).matrix() - T_true))


def _transform_gap(T, T_cpu):
    """Largest difference of the translations and of the quaternion
    components of two (batched) transforms."""
    return max(float((a.cpu() - b).abs().max()) for a, b in zip(T, T_cpu))


def _busy(fn):
    """(wall ms of one synchronized run, device ms that torch.profiler
    records over another, its top 5 kernels by device time as (name,
    calls, ms), its kernel count)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    return wall, device, [(e.key[:48], e.count,
                           e.self_device_time_total / 1e3)
                          for e in kernels[:5]], sum(e.count for e in kernels)


def _info_checked(what, info, info_cpu):
    """Symmetric positive definite, and equal to the same estimate on the
    CPU within CARD_CPU_INFO_RTOL of its largest entry."""
    I = info.double().cpu()
    scale = float(I.abs().max())
    asym = float((I - I.T).abs().max()) / scale
    eig = torch.linalg.eigvalsh(0.5 * (I + I.T))
    rel = float((I - info_cpu.double()).abs().max()) / scale
    check(asym <= 1e-4 and bool((eig > 0).all())
          and rel <= CARD_CPU_INFO_RTOL, f"{what}: asymmetry {asym}, "
          f"eigenvalues {eig.tolist()}, card vs CPU {rel}")
    return f"min eigenvalue {float(eig.min()):.4e}, asymmetry {asym:.2e}, " \
        f"card vs CPU {rel:.3e}"


def _to(res, device):
    """An ICP result's tensors on ``device``."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return type(x)(*(move(y) for y in x))

    return move(res)


def phase_icp(dev, smi):
    """bench.py's icp configuration: the 4,096-point pair, multiscale and
    single-scale ICP, the numpy anchor, GICP, NDT, LUM and Censi."""
    ref, tgt, t_true = bench_lidar.scan_pair()
    _lidar_data("icp", "pair", ref, tgt)
    c, s_ = np.cos(bench_lidar.PAIR_YAW), np.sin(bench_lidar.PAIR_YAW)
    T_true = torch.eye(4, dtype=torch.float64)
    T_true[:3, :3] = torch.tensor([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
    T_true[:3, 3] = torch.as_tensor(t_true, dtype=torch.float64)
    pair = (make_cloud(ref, device=dev), make_cloud(tgt, device=dev))
    pair_cpu = (make_cloud(ref, device="cpu"), make_cloud(tgt, device="cpu"))
    t_true = torch.as_tensor(t_true)
    out, rates = {}, {}
    for name, fn, params in (
            ("multiscale", icp_match, bench_lidar.ICP_MULTISCALE),
            ("singlescale", icp_match, bench_lidar.ICP_SINGLE),
            ("gicp", gicp_match, bench_lidar.GICP),
            ("ndt", ndt_match, bench_lidar.NDT)):
        res, inside, _ = _lidar_checked(f"icp {name}",
                                        lambda: fn(*pair, params))
        again = fn(*pair, params)
        check(_same_bits(res.transform, again.transform),
              f"icp {name}: two card runs differ")
        is_icp = fn is icp_match
        res_cpu = fn(*pair_cpu, params) if is_icp else None
        gap = _transform_gap(res.transform, res_cpu.transform) if is_icp \
            else 0.0
        err = float((res.transform.t.cpu() - t_true).norm())
        td = _t_diff(res.transform, T_true)
        jax_err = JAX_ICP_ERR[name]
        bound = (SINGLESCALE_BOUND_M if name == "singlescale"
                 else 1.5 * jax_err + 1e-3)
        check(err <= bound and td < ICP_THRESHOLD and gap <= CARD_CPU_T_TOL,
              f"icp {name}: translation error {err} m (bound {bound}; the "
              f"JAX package's {jax_err}), ||T - T_true|| {td}, card vs CPU "
              f"{gap}")
        rates[name] = 1e3 / _median_ms(lambda: fn(*pair, params), reps=5)
        out[name] = res
        vs_cpu = (f"{int(res_cpu.iterations)} on the CPU, card vs CPU "
                  f"{gap:.3e} (tol {CARD_CPU_T_TOL})" if is_icp
                  else "not run on the CPU")
        print(f"icp {name}: {params} | translation "
              f"error {err:.6e} m (the JAX package's {jax_err:.6e}; bound "
              f"{bound:.4e}), ||T - T_true||_F {td:.6e} (< {ICP_THRESHOLD}), "
              f"{int(res.iterations)} iterations ({vs_cpu}), same bits "
              f"twice, {rates[name]:.3f} pairs/s; synchronizing calls "
              f"inside: {_sites(inside)}")
    t0 = time.perf_counter()
    t_np = bench_lidar.numpy_icp(ref, tgt)
    np_s = time.perf_counter() - t0
    np_err = float(np.linalg.norm(t_np - t_true.numpy()))
    keys = {
        "icp_scan_pairs_per_s": rates["multiscale"],
        "icp_translation_err_m": float(
            (out["multiscale"].transform.t.cpu() - t_true).norm()),
        "icp_singlescale_pairs_per_s": rates["singlescale"],
        "icp_pairs_per_s_numpy_cpu": 1.0 / np_s,
        "icp_vs_numpy_cpu": np_s * rates["singlescale"],
        "icp_numpy_t_err_m": np_err,
    }
    print(f"icp: bench.py's keys {json.dumps(keys)} (numpy anchor on this "
          f"machine's CPU, neighbours by native.knn_exact, route "
          f"{native.route()}) | {smi}")

    # information of the multiscale result, and the same result's on the
    # CPU
    res = out["multiscale"]
    res_cpu = _to(res, "cpu")
    censi = dataclasses.replace(bench_lidar.ICP_MULTISCALE,
                                covar_estimator="CENSI")
    lum = _info_checked("icp LUM", estimate_info_lum(res),
                        estimate_info_lum(res_cpu))
    cen = _info_checked("icp Censi", estimate_info_censi(res, censi),
                        estimate_info_censi(res_cpu, censi))
    print(f"icp information of the multiscale result: LUM {lum}; Censi "
          f"{cen} (rtol {CARD_CPU_INFO_RTOL})")

    # where a trip's time goes: one multiscale match profiled, and the
    # batched 3x3 SVD alone
    wall, device, top, events = _busy(
        lambda: icp_match(*pair, bench_lidar.ICP_MULTISCALE))
    trips = int(res.iterations)
    print(f"icp multiscale profile: {wall:.3f} ms of wall, {device:.3f} ms "
          f"of device time (busy share {device / wall:.4f}), {events} "
          f"kernels over {trips} trips; top: "
          + "; ".join(f"{k} x{n} {ms:.3f} ms" for k, n, ms in top))
    for B in (1, ODOMETRY_T - 1):
        H = torch.randn(B, 3, 3, device=dev)
        (_, syncs) = _sync_free(lambda: torch.linalg.svd(H))
        ms = _median_ms(lambda: torch.linalg.svd(H), reps=20)
        print(f"icp: torch.linalg.svd of ({B}, 3, 3) f32: {ms:.4f} ms "
              f"(synchronized host clock, median of 20); synchronizing "
              f"calls: {sum(syncs.values())}")


def phase_lidar_odometry(dev, smi):
    """lidar_odometry on bench_lidar.scan_sequence(ODOMETRY_T, 4096): the
    pairs in one batch, full-resolution ICP with LUM information and the
    pose-graph refinement, bench.py's multiscale ICP, NDT."""
    pts, mask, _, p_true = bench_lidar.scan_sequence(ODOMETRY_T, 4096)
    _lidar_data("lidar_odometry", "sequence", pts, mask)
    pts32 = pts.astype(np.float32)
    scans = PointCloud(torch.as_tensor(pts32).to(dev),
                       torch.as_tensor(mask).to(dev))
    k = ODOMETRY_CPU_PAIRS + 1
    scans_cpu = PointCloud(torch.as_tensor(pts32[:k]),
                           torch.as_tensor(mask[:k]))
    pairs = ODOMETRY_T - 1
    runs = {
        "icp_refined": (icp_match, LidarOdometryConfig(
            icp=bench_lidar.ODOMETRY_ICP, refine_pose_graph=True,
            pose_graph=PoseGraphConfig())),
        "icp_multiscale": (icp_match, LidarOdometryConfig(
            icp=bench_lidar.ICP_MULTISCALE)),
        "ndt": (ndt_match, LidarOdometryConfig(
            icp=bench_lidar.NDT, estimate_information=False)),
    }
    for name, (matcher, cfg) in runs.items():
        def run():
            return lidar_odometry(scans, cfg, matcher=matcher)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        again, inside, host = _lidar_checked(f"lidar_odometry {name}", run)
        check(_same_bits(res.trajectory, again.trajectory)
              and torch.equal(res.information, again.information),
              f"lidar_odometry {name}: two card runs differ")
        err = float(np.linalg.norm(res.trajectory.t.double().cpu().numpy()
                                   - p_true, axis=-1).max())
        jax_err = JAX_ODOMETRY_ERR[name]
        check(bool(res.converged.all()) and err <= 1.5 * jax_err + 1e-3,
              f"lidar_odometry {name}: converged {res.converged.tolist()}, "
              f"worst position error {err} m (the JAX package's {jax_err})")
        t0 = time.perf_counter()
        cpu = lidar_odometry(scans_cpu, cfg, matcher=matcher)
        cpu_s = time.perf_counter() - t0
        first = SE3(res.relative.q[:k - 1], res.relative.t[:k - 1])
        gap = _transform_gap(first, cpu.relative)
        check(gap <= CARD_CPU_T_TOL, f"lidar_odometry {name}: the first "
              f"{k - 1} pairs part from the CPU's by {gap}")
        print(f"lidar_odometry {name}: {pairs} pairs of 4,096 points, f32, "
              f"one batch: worst position error {err:.6e} m (the JAX "
              f"package's {jax_err:.6e}; bound 1.5x + 1 mm), all converged, "
              f"iterations {min(res.iterations.tolist())}-"
              f"{max(res.iterations.tolist())}, {pairs / wall:.3f} pairs/s "
              f"({wall:.3f} s), peak allocated {peak:.3f} GiB; same bits "
              f"twice; first {k - 1} pairs card vs CPU {gap:.3e} (tol "
              f"{CARD_CPU_T_TOL}; CPU {cpu_s:.3f} s); synchronizing calls "
              f"inside the matchers: {_sites(inside)}; outside: "
              f"{_sites(host)} | {smi}")
        if name == "icp_refined":
            w, device, top, events = _busy(run)
            print(f"lidar_odometry {name} profile: {w:.3f} ms of wall, "
                  f"{device:.3f} ms of device time (busy share "
                  f"{device / w:.4f}), {events} kernels; top: "
                  + "; ".join(f"{k_} x{n} {ms:.3f} ms" for k_, n, ms in top))


def phase_ground(dev, smi):
    """segment_ground on ground_scene() (116,800 points) at the default
    bins (72 x 200, rmax 100 m)."""
    pts, labels = bench_lidar.ground_scene()
    _lidar_data("ground", "ground", pts, labels)
    params = bench_lidar.GROUND_PARAMS
    cloud = make_cloud(pts, device=dev)
    reset_launches()
    got = segment_ground(cloud, params).labels
    check(not any(launch_counts().values()), "ground: launched a kernel")
    again = segment_ground(cloud, params).labels
    got = got.cpu().numpy()
    cpu = segment_ground(make_cloud(pts, device="cpu"), params).labels
    agree = float((got == cpu.numpy()).mean())
    scores = bench_lidar.ground_scores(got, labels)
    off = {k: abs(v - JAX_GROUND[k]) for k, v in scores.items()}
    check(max(off.values()) <= GROUND_SCORE_TOL and agree >= GROUND_AGREE,
          f"ground: scores {scores} (the JAX package's {JAX_GROUND}), "
          f"card vs CPU labels agree on {agree}")
    ms = _median_ms(lambda: segment_ground(cloud, params), reps=10)
    print(f"ground: {len(pts)} points, {params.num_bins_a} x "
          f"{params.num_bins_l} bins, f32: "
          + ", ".join(f"{k} {v:.6f} (JAX {JAX_GROUND[k]:.6f})"
                      for k, v in scores.items())
          + f"; card vs CPU labels agree on {agree:.6f} (gate "
          f"{GROUND_AGREE}); same labels twice "
          f"{bool((again.cpu().numpy() == got).all())}; {ms:.3f} ms per "
          f"scan (synchronized host clock, median of 10) | {smi}")


def _frame_bank(frame, dev, params=FASTParams(threshold=20.0, num_features=512)):
    img = torch.as_tensor(frame, device=dev).to(torch.float32)
    xy, _, m = detect_fast(img, params)
    desc, m = brisk_describe(img, xy, m)
    return xy, desc, m


def _hamming_cases(frames, dev):
    """(name, d1, d2, mask2) int32 banks on the card. The frame case is two
    consecutive frames' BRISK banks, as the tracker matches them."""
    rng = np.random.default_rng(2)

    def bank(n, w):
        words = rng.integers(0, 2**32, (n, w), dtype=np.uint64)
        return words.astype(np.uint32).view(np.int32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    _, d_prev, _ = _frame_bank(frames[0], dev)
    _, d_curr, m_curr = _frame_bank(frames[1], dev)
    d2 = bank(700, 8)
    d2[500:] = d2[:200]  # duplicate reference rows: ties at the best
    d1 = np.concatenate([d2[:100], bank(200, 8)])
    mask = rng.random(700) < 0.7
    one = np.zeros(700, bool)
    one[333] = True
    big2 = bank(16384, 16)
    big1 = big2[rng.permutation(16384)].copy()
    big1 ^= (rng.random(big1.shape) < 0.05).astype(np.int32) << 7  # near copies
    edges = [(f"edge: {name}", t(a.view(np.int32)), t(b.view(np.int32)),
              None if m is None else t(m))
             for name, a, b, m in bench_frontend.top2_edge_cases()]
    return {
        "both": [
            ("frame 512x512x16", d_prev, d_curr, m_curr),
            ("300x700x8 ties, mask zeros", t(d1), t(d2), t(mask)),
            ("300x700x8 all masked", t(d1), t(d2), t(np.zeros(700, bool))),
            ("300x700x8 one live column", t(d1), t(d2), t(one)),
            *edges,
        ],
        "top2": ("16384x16384x16", t(big1), t(big2), None),
    }


def _exact(case, got, ref, stats):
    """Integer outputs: count mismatches and the largest difference."""
    for g, r in zip(got, ref):
        diff = (g.to(torch.int64) - r.to(torch.int64)).abs()
        stats["mismatches"] += int((diff != 0).sum())
        stats["max_abs_err"] = max(stats["max_abs_err"], float(diff.max()))
    check(stats["mismatches"] == 0,
          f"{case}: kernel and plain version differ in {stats['mismatches']} "
          f"entries (max abs err {stats['max_abs_err']:g})")


def _bits(d):
    """(N, W) int32 words -> (N, 32 W) f32 0/1 bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    return ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], -1).float()


def _table_library(d1, d2, reps):
    """Device ms of ``torch.cdist(a, b, p=0)`` on the banks unpacked to 0/1
    f32 bits, the unpack outside the timed region: the one PyTorch call
    that computes the Hamming table; and whether it equals the plain table.
    (None, None), with the reason printed, where it does not run on the
    card."""
    a, b = _bits(d1), _bits(d2)
    try:
        table = torch.cdist(a, b, p=0)
        torch.cuda.synchronize()
        ms = bench_problem.device_ms(lambda: torch.cdist(a, b, p=0), reps)
    except RuntimeError as e:
        print(f"hamming: library call: none, torch.cdist(p=0) does not run on "
              f"the card here: {str(e).splitlines()[0]}")
        return None, None
    same = torch.equal(table.to(torch.int32),
                       hamming.hamming_distance_reference(d1, d2))
    return ms, same


def _unaligned(d, dev):
    """A contiguous copy of ``d`` 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(d.numel() + 1, dtype=d.dtype, device=dev)
    view = flat[1:].view(d.shape)
    view.copy_(d)
    return view


def phase_hamming(frames, dev, smi, popc_rate):
    cases = _hamming_cases(frames, dev)
    out = {k: {"mismatches": 0, "max_abs_err": 0.0} for k in ("top2", "table")}
    big1, big2 = cases["top2"][1:3]
    mid = ("2048x2048x16", big1[:2048], big2[:2048], None)
    for name, d1, d2, m2 in cases["both"] + [mid, cases["top2"]]:
        got = hamming.hamming_top2(d1, d2, m2)
        ref = hamming.hamming_top2_reference(d1, d2, m2)
        torch.cuda.synchronize()
        _exact(f"top-2 {name}", got, ref, out["top2"])
    table_edges = [(name, *(torch.as_tensor(x.view(np.int32), device=dev)
                            for x in banks), None)
                   for name, *banks in bench_frontend.table_edge_cases()]
    d_unaligned = _unaligned(big2[:600], dev)
    check(d_unaligned.data_ptr() % 16 != 0, "hamming: the unaligned bank is "
          "16-byte aligned")
    tables = [(f"{n}x{n}x16", big1[:n], big2[:n], None) for n in (4096, 8192)]
    for name, d1, d2, m2 in (cases["both"] + table_edges + tables + [
            ("600x600x16 banks 4 bytes past a 16-byte boundary",
             d_unaligned, d_unaligned, None)]):
        got = hamming.hamming_distance(d1, d2)
        ref = hamming.hamming_distance_reference(d1, d2)
        torch.cuda.synchronize()
        _exact(f"table {name}", (got,), (ref,), out["table"])
        del got, ref
    print(f"hamming: top-2 and table kernels equal their plain versions "
          f"exactly at {', '.join(c[0] for c in cases['both'])}; the top-2 "
          f"also at {mid[0]} and {cases['top2'][0]}; the table also at "
          f"{', '.join(c[0] for c in table_edges + tables)} and on banks 4 "
          f"bytes past a 16-byte boundary")

    frame = cases["both"][0][1:]
    for name, ops, reps, plain_reps in (
            ("frame 512x512x16", frame, 50, 50),
            (mid[0], mid[1:], 20, 2),
            (cases["top2"][0], cases["top2"][1:], 5, 1)):
        ms = _time_calls(hamming.hamming_top2, [ops], reps)
        plain_ms = _time_calls(hamming.hamming_top2_reference, [ops],
                               plain_reps)
        # bytes: both banks and the mask read once, three int32 outputs
        # written once; operations: one XOR + popcount per word pair, at
        # the popcount issue rate
        n1, w = ops[0].shape
        n2 = ops[1].shape[0]
        mask_bytes = n2 if ops[2] is not None else 0
        bound_ms, bound_by = bound((n1 + n2) * w * 4 + mask_bytes + 3 * n1 * 4,
                                   n1 * n2 * w, popc_rate)
        if name.startswith("frame"):
            out["top2"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
        print(f"hamming: top2 {name}: {ms:.4f} ms (kernel) vs "
              f"{plain_ms:.4f} ms (plain); bound {bound_ms:.4f} ms "
              f"({bound_by}), device time | {smi}")
    out["top2"]["library_ms"] = None  # no one PyTorch call computes a top-2

    for name, (d1, d2), reps, plain_reps in (
            ("frame 512x512x16", frame[:2], 50, 50),
            (tables[0][0], tables[0][1:3], 10, 2),
            (tables[1][0], tables[1][1:3], 5, 1)):
        ms = _time_calls(hamming.hamming_distance, [(d1, d2)], reps)
        plain_ms = _time_calls(hamming.hamming_distance_reference, [(d1, d2)],
                               plain_reps)
        lib_ms, lib_same = _table_library(d1, d2, plain_reps)
        # bytes: both banks read once, the int32 table written once (the
        # products on the tensor cores take far less: csrc/hamming.cu)
        n1, w = d1.shape
        n2 = d2.shape[0]
        bound_ms, bound_by = bound((n1 + n2) * w * 4 + n1 * n2 * 4)
        if name.startswith("frame"):
            out["table"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=lib_ms)
        lib = ("none" if lib_ms is None else
               f"{lib_ms:.4f} ms (torch.cdist(p=0) on 0/1 f32 bits, equal to "
               f"the plain table: {lib_same})")
        print(f"hamming: table {name}: {ms:.4f} ms (kernel) vs "
              f"{plain_ms:.4f} ms (plain) vs {lib} (library); bound "
              f"{bound_ms:.6f} ms ({bound_by}); "
              f"{n1 * n2 * 4 / ms / 1e9:.3f} TB/s of table written; device "
              f"time | {smi}")
    return out


def _top2(plain):
    """Route the matcher's top-2 to the kernel or to the plain version."""
    return mock.patch.object(
        hamming, "hamming_top2",
        hamming.hamming_top2_reference if plain else hamming.hamming_top2,
    )


def _table(plain):
    """Route the matcher's distance table to the kernel or the plain one."""
    return mock.patch.object(
        hamming, "hamming_distance",
        hamming.hamming_distance_reference if plain else hamming.hamming_distance,
    )


def phase_pair(dev, smi):
    img1, img2 = (torch.as_tensor(a, device=dev)
                  for a in bench_frontend.pair_images(0))
    fast_p = FASTParams(num_features=512)

    def pair(mp):
        gen = torch.Generator(device=dev).manual_seed(0)
        xy1, _, m1 = detect_fast(img1, fast_p)
        xy2, _, m2 = detect_fast(img2, fast_p)
        d1, _ = brisk_describe(img1, xy1, m1)
        d2, _ = brisk_describe(img2, xy2, m2)
        _, valid, diag = matcher.match_descriptors(
            d1, d2, xy1, xy2, m1, m2, gen, mp)
        return diag["num_good_matches"], valid

    knn = matcher.MatcherParams()
    reps = 20
    rates, good = {}, {}
    for which in ("kernel", "plain"):
        with _top2(which == "plain"):
            hamming.hamming_top2.launches = 0
            dt, (n_good, valid) = bench_frontend.time_call(pair, knn, reps=reps)
            launches = hamming.hamming_top2.launches
        want = reps + 1 if which == "kernel" else 0
        check(launches == want, f"pair ({which} top-2): {launches} top-2 "
              f"kernel launches in {reps + 1} pairs, expected {want}")
        rates[which], good[which] = 1.0 / dt, (int(n_good), valid.cpu())
    check(good["kernel"][0] >= 50 and torch.equal(good["kernel"][1],
                                                   good["plain"][1]),
          f"pair: {good['kernel'][0]} good matches with the kernel, "
          f"{good['plain'][0]} with the plain top-2")
    for which, note in (("kernel", ", one top-2 launch per pair"),
                        ("plain", "")):
        print(f"pair: 480x640 blob pair, FAST-512 + BRISK + knn ratio + "
              f"RANSAC: {good[which][0]} good matches, {rates[which]:.3f} "
              f"pairs/s with the {which} top-2{note} | {smi}")

    heur = matcher.MatcherParams(use_knn=False, cross_check=True)
    hamming.hamming_distance.launches = 0
    n_good, valid = pair(heur)
    table_launches = hamming.hamming_distance.launches
    check(table_launches == 1,
          f"pair (distance heuristic): {table_launches} table launches")
    with _table(plain=True):
        n_plain, valid_plain = pair(heur)
    check(hamming.hamming_distance.launches == 1
          and torch.equal(valid, valid_plain),
          "pair (distance heuristic): kernel and plain table disagree")
    print(f"pair: the same pair through the distance heuristic with cross "
          f"check: 1 table kernel launch, {int(n_good)} good matches, the "
          f"same as with the plain table")
    return table_launches


def _track(frames, dev, plain):
    gen = torch.Generator(device=dev).manual_seed(0)
    with _top2(plain):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracks = visual_frontend.track_sequence(
            frames, params=visual_frontend.FrontendParams(), generator=gen,
            device=dev)
        dt = time.perf_counter() - t0  # the tracks are on the host
    return tracks, dt


def _median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _frame_layers(frames, dev, smi):
    """ms per frame of each layer of one tracker step (frame 1 after frame
    0), CUDA-synchronized host clock, median of 20."""
    params = visual_frontend.FrontendParams()
    tp = params.tracker
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tracker_init(tp, visual_frontend._desc_words(params), device=dev)
    img0 = torch.as_tensor(frames[0], device=dev)
    img1 = torch.as_tensor(frames[1], device=dev)
    state = visual_frontend._frontend_step(state, img0, 0.0, gen, params)
    img = img1.to(torch.float32)
    xy, _, m = detect_fast(img, params.fast)
    desc, m = brisk_describe(img, xy, m, params.brisk)
    best, second, idx2 = hamming.hamming_top2(state.prev_desc, desc, m)
    valid = (best.float() <= tp.matcher.ratio_threshold * second.float()) & \
        (best < hamming.BIG) & state.prev_mask
    p2 = xy[idx2.long()]
    layers = {
        "detect": lambda: detect_fast(img, params.fast),
        "describe": lambda: brisk_describe(img, xy, m, params.brisk),
        "top-2 match": lambda: hamming.hamming_top2(state.prev_desc, desc, m),
        "RANSAC": lambda: matcher.find_fundamental_ransac(
            state.prev_xy, p2, valid, gen),
        "tracker update (match + RANSAC + ids + buffer)":
            lambda: add_image_features(state, xy, desc, m, 1.0, gen, tp),
        "whole frame step": lambda: visual_frontend._frontend_step(
            state, img1, 1.0, gen, params),
    }
    parts = [f"{k} {_median_ms(fn):.3f}" for k, fn in layers.items()]
    print(f"sequence: ms per 752x480 frame by layer: {'; '.join(parts)} | "
          f"{smi}")
    return state, img1


def _sync_sites(state, img, dev):
    """Synchronizing calls that PyTorch's sync debug mode sees in one frame
    step, as {file name:line: count}."""
    params = visual_frontend.FrontendParams()
    gen = torch.Generator(device=dev).manual_seed(1)
    _, syncs = _sync_free(lambda: visual_frontend._frontend_step(
        state, img, 1.0, gen, params))
    sites = collections.Counter()
    for k, v in syncs.items():
        sites[Path(k).name] += v
    return sites


def phase_sequence(frames, dev, smi):
    hamming.hamming_top2.launches = 0
    tracks, _ = _track(frames, dev, plain=False)
    launches = hamming.hamming_top2.launches
    check(launches == SEQUENCE_FRAMES,
          f"sequence: {launches} top-2 launches in {SEQUENCE_FRAMES} frames")
    tracks_p, _ = _track(frames, dev, plain=True)
    check(hamming.hamming_top2.launches == launches,
          "sequence: the plain run launched the top-2 kernel")
    check(np.array_equal(tracks, tracks_p),
          f"sequence: tracks with the kernel ({len(tracks)} rows) and with "
          f"the plain top-2 ({len(tracks_p)} rows) differ")
    check(np.isfinite(tracks).all(), "sequence: non-finite track rows")
    ids = np.unique(tracks[:, 1])
    lengths = np.bincount(tracks[:, 1].astype(int))
    lengths = lengths[lengths > 0]
    longest = tracks[tracks[:, 1] == ids[np.argmax(lengths)]]
    check((np.diff(np.sort(longest[:, 0].astype(int))) == 1).all(),
          "sequence: the longest track skips frames")
    check(lengths.mean() >= 3.0,
          f"sequence: mean track length {lengths.mean():.3f} < 3")
    for what, got, ref in (("track rows", len(tracks), JAX_TRACK_ROWS),
                           ("landmark ids", len(ids), JAX_TRACK_IDS)):
        check(abs(got - ref) <= 0.1 * max(got, ref),
              f"sequence: {got} {what} against the JAX package's {ref}")
    print(f"sequence: {SEQUENCE_FRAMES} frames 752x480, FrontendParams(): "
          f"{launches} top-2 kernel launches, tracks identical to the plain "
          f"top-2 run: {len(tracks)} track rows (JAX {JAX_TRACK_ROWS}), "
          f"{len(ids)} ids (JAX {JAX_TRACK_IDS}), mean length "
          f"{lengths.mean():.3f}, longest {lengths.max()} contiguous frames")
    rates = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        _, dt = _track(frames, dev, plain=which == "plain")
        rates[which].append(SEQUENCE_FRAMES / dt)
    for which in ("kernel", "plain"):
        r = rates[which]
        print(f"sequence: {np.mean(r):.3f} frames/s with the {which} top-2 "
              f"(runs {r[0]:.3f}, {r[1]:.3f}), whole track_sequence incl. "
              f"upload and track export | {smi}")
    state, img = _frame_layers(frames, dev, smi)
    sites = _sync_sites(state, img, dev)
    src = Path(inspect.getsourcefile(matcher))
    allowed = {f"{src.name}:{i}" for i, line in
               enumerate(src.read_text().splitlines(), 1)
               if "torch.linalg." in line}
    listed = ", ".join(f"{k} x{v}" for k, v in sorted(sites.items())) or "none"
    print(f"sequence: synchronizing calls in one frame step: {listed}")
    stray = sorted(set(sites) - allowed)
    check(not stray, f"sequence: synchronizing calls outside RANSAC's "
          f"torch.linalg calls: {stray}")
    return launches


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _synced(fn):
    """(result, seconds) of ``fn`` on a synchronized host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _track_stats(tracks):
    ids = np.unique(tracks[:, 1])
    lengths = np.bincount(tracks[:, 1].astype(int))
    lengths = lengths[lengths > 0]
    return len(tracks), len(ids), float(lengths.mean())


def _syncs_per_frame(frames, dev, params):
    """Synchronizing calls of ``track_sequence`` as (per frame, per
    sequence, sites of a 6-frame run): runs of 3 and 6 frames tell the
    calls each frame makes from those made once (the upload of the times,
    the track export)."""
    def sites(n):
        _, syncs = _sync_free(lambda: visual_frontend.track_sequence(
            frames[:n], params=params, generator=_gen(dev, 3), device=dev))
        out = collections.Counter()
        for k, v in syncs.items():
            out[f"{Path(k).name}:{k.rsplit(':', 1)[1]}"] += v
        return out

    three, six = sites(3), sites(6)
    per_frame = (sum(six.values()) - sum(three.values())) / 3
    return per_frame, sum(three.values()) - 3 * per_frame, six


def phase_pixels(dev, smi):
    """bench.py's pixels configuration through run_euroc_vio_from_images."""
    p = PIXELS_SIM
    K = np.array([[p.fx, 0, p.cx], [0, p.fy, p.cy], [0, 0, 1.0]])
    params = euroc_vio.EurocVIOParams()
    cfg = euroc_vio.default_vio_config(params)
    it = cfg.max_iterations
    fp = visual_frontend.FrontendParams()
    with tempfile.TemporaryDirectory(prefix="pixels_") as root:
        # the writer's IMU noise from a CPU generator: the directory this
        # machine writes is the one any other writes
        t0 = time.perf_counter()
        euroc_sim.generate_euroc_sequence(root, p, seed=0, device="cpu")
        gen_s = time.perf_counter() - t0
        _, paths = load_euroc_camera_index(root)
        t0 = time.perf_counter()
        frames = images.read_image_sequence(paths)
        decode_s = time.perf_counter() - t0
        T = len(frames)
        check(np.array_equal(frames, euroc_sim.cam0_frames(p, seed=0)),
              "pixels: the decoded PNGs differ from the rendered frames")
        want = dict(dense_g_a_window=it, seg_reduce_sorted=3 * it,
                    seg_broadcast=it, hamming_top2=T, hamming_distance=0,
                    pcg_trip=0, schur_self_blocks=0)
        reset_launches()
        _, rep = euroc_vio.run_euroc_vio_from_images(
            root, params, K=K, generator=_gen(dev, 0), device=dev)
        counts = launch_counts()
        check(counts == want, f"pixels: launches {counts} for {T} frames and "
              f"{it} LM iterations, expected {want}")
        ate, ate0 = rep["ate_rmse"], rep["ate_rmse_deadreckon"]
        check(np.isfinite(rep["final_cost"])
              and rep["final_cost"] < rep["initial_cost"],
              f"pixels: cost {rep['initial_cost']} -> {rep['final_cost']}")
        check(ate < PIXELS_ATE_BOUND_M and ate < 0.5 * ate0
              and rep["num_tracks"] >= PIXELS_MIN_TRACKS,
              f"pixels: ATE {ate} m (dead reckoning {ate0} m, bound "
              f"{PIXELS_ATE_BOUND_M} m and half of it), {rep['num_tracks']} "
              f"tracks (>= {PIXELS_MIN_TRACKS})")

        tracks = visual_frontend.track_sequence(frames, params=fp,
                                                generator=_gen(dev, 0),
                                                device=dev)
        with _top2(plain=True):
            tracks_p = visual_frontend.track_sequence(
                frames, params=fp, generator=_gen(dev, 0), device=dev)
        check(np.array_equal(tracks, tracks_p), "pixels: tracks with the "
              "top-2 kernel and with its plain version differ")
        check(len(tracks) == rep["num_track_measurements"], f"pixels: "
              f"track_sequence gave {len(tracks)} rows, the entry point "
              f"{rep['num_track_measurements']}")
        (problem, init, gt, kf), build_s = _synced(
            lambda: euroc_vio.build_euroc_vio_problem(
                root, params, K, tracks=tracks, device=dev))
        # the solve behind the images, held as phase_euroc holds its own:
        # launches, no sync outside torch.linalg, and the same problem
        # solved on the CPU through the plain versions
        reset_launches()
        (state, info), syncs = _sync_free(
            lambda: vio.solve_vio(problem, init, cfg))
        solve_counts = launch_counts()
        want_solve = dict(want, hamming_top2=0)
        check(solve_counts == want_solve, f"pixels: launches {solve_counts} "
              f"in the solve's {it} LM iterations, expected {want_solve}")
        stray = sorted(set(syncs) - _linalg_sites())
        check(not stray, f"pixels: synchronizing calls inside solve_vio "
              f"outside torch.linalg: {stray}")
        rep_s = euroc_vio.euroc_report(gt, kf, init, state, info)
        held = {}
        with _held_to_plain("pixels", held):
            state_h, _ = vio.solve_vio(problem, init, cfg)
        check({k: v["calls"] for k, v in held.items()} == {
            k: v for k, v in want_solve.items() if v},
            f"pixels: {held} calls held to the plain versions, expected "
            f"{want_solve}")
        rerun_same = torch.equal(state_h.p, state.p)
        # the same problem on the CPU through the plain versions. The f32
        # solve stops short of its minimum in 25 iterations, the JAX
        # package's too (tests/pixels_f32_spread.py), so its positions
        # follow the summation order by millimetres: held are the final
        # cost (rtol 1e-4) and the ATE (1.5x + 1 mm of the CPU's); the
        # positions' gap and the CPU's own spread between thread counts
        # are printed
        cpu = torch.device("cpu")
        problem_c, init_c, gt_c, kf_c = euroc_vio.build_euroc_vio_problem(
            root, params, K, tracks=tracks, device=cpu)
        est_c, info_c = vio.solve_vio(problem_c, init_c, cfg)
        rep_c = euroc_vio.euroc_report(gt_c, kf_c, init_c, est_c, info_c)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            est_1, _ = vio.solve_vio(problem_c, init_c, cfg)
        finally:
            torch.set_num_threads(threads)
        cost, cost_c = rep_s["final_cost"], rep_c["final_cost"]
        dp = float((state.p.cpu() - est_c.p).abs().max())
        dp_cpu = float((est_1.p - est_c.p).abs().max())
        check(abs(cost - cost_c) <= 1e-4 * abs(cost_c)
              and rep_s["ate_rmse"] <= 1.5 * rep_c["ate_rmse"] + 1e-3,
              f"pixels: card final cost {cost} vs CPU {cost_c}, ATE "
              f"{rep_s['ate_rmse']} m vs {rep_c['ate_rmse']} m")
        solve_s = [_synced(lambda: float(vio.solve_vio(
            problem, init, cfg)[1]["final_cost"]))[1] for _ in range(2)]
        N = init.q.shape[0]
        front = lambda: visual_frontend.track_sequence(  # noqa: E731
            frames, params=fp, generator=_gen(dev, 0), device=dev)
        front_s = [_synced(front)[1] for _ in range(2)]
        wall, device_ms, top, n_kernels = _busy(front)
        per_frame, per_seq, sites = _syncs_per_frame(frames, dev, fp)
    print(f"pixels: bench.py's pixels sequence ({p.duration:g} s, {T} frames "
          f"{p.width}x{p.height_px}, {p.nb_landmarks} landmarks, seed 0) "
          f"written with the port's save_png in {gen_s:.3f} s, read back by "
          f"its zlib + numpy decoder in {decode_s:.3f} s "
          f"({T / decode_s:.1f} frames/s), equal to the rendered frames bit "
          f"for bit")
    print(f"pixels: run_euroc_vio_from_images on the card: launches "
          f"{counts} ({T} top-2 = 1 per frame; {it} dense LM iterations: 1 "
          f"G/A, 3 reduce, 1 broadcast each); {rep['num_tracks']} tracks, "
          f"{rep['num_track_measurements']} rows (kernel and plain top-2 "
          f"give the same tracks); ATE {ate:.6f} m (dead reckoning "
          f"{ate0:.6f} m; bounds {PIXELS_ATE_BOUND_M} m and half the dead "
          f"reckoning), RPE {rep['rpe_trans_rmse']:.6f} m | {smi}")
    listed = ", ".join(f"{Path(k).name}:{k.rsplit(':', 1)[1]} x{v}"
                       for k, v in sorted(syncs.items())) or "none"
    print(f"pixels: the solve on the card: launches {solve_counts}; "
          f"synchronizing calls: {listed}; every call held to its plain "
          f"version on the same inputs ("
          + ", ".join(f"{k} {v['calls']} calls, max abs err "
                      f"{v['max_abs_err']:.3e}" for k, v in held.items())
          + f"; segment kernels bit for bit, G/A rtol {REL_TOL:g}); against "
          f"the CPU's (plain versions, same tracks): final cost "
          f"{cost:.6e} vs {cost_c:.6e} (relative difference "
          f"{abs(cost / cost_c - 1):.3e}, rtol 1e-4), ATE "
          f"{rep_s['ate_rmse']:.6f} m vs {rep_c['ate_rmse']:.6f} m (bound "
          f"1.5x + 1 mm), keyframe positions {dp:.3e} m apart (the CPU's "
          f"1 thread against {threads}: {dp_cpu:.3e} m); the held run's "
          f"positions {'equal' if rerun_same else 'differ from'} the counted "
          f"run's | {smi}")
    print(f"pixels: front end {T / np.median(front_s):.3f} frames/s (runs "
          f"{', '.join(f'{T / t:.3f}' for t in front_s)}; in the entry point "
          f"{rep['frontend_frames_per_s']:.3f}, its first call); solve "
          f"{N / np.median(solve_s):.3f} keyframes/s ({N} keyframes, {it} LM "
          f"iterations, runs {', '.join(f'{N / t:.3f}' for t in solve_s)}); "
          f"build {build_s:.3f} s; front-end busy share "
          f"{device_ms / wall:.3f} ({device_ms:.1f} ms of device time in "
          f"{wall:.1f} ms, {n_kernels} kernels); synchronizing calls "
          f"{per_frame:g} a frame and {per_seq:g} a sequence (6 frames: "
          f"{', '.join(f'{k} x{v}' for k, v in sorted(sites.items()))}) | "
          f"{smi}")
    return counts


def _orb_bank_agreement(frame, dev, params):
    """Keypoint overlap and rBRIEF bit agreement of one frame's ORB bank
    on the card and on this machine's CPU."""
    banks = [visual_frontend.detect_and_describe(
        torch.as_tensor(frame, device=d), params) for d in (dev, "cpu")]
    rows = [{tuple(p): w for p, w, m in zip(
        xy.cpu().numpy(), desc.cpu().numpy(), mask.cpu().numpy()) if m}
        for xy, desc, mask in banks]
    shared = sorted(set(rows[0]) & set(rows[1]))
    overlap = len(shared) / max(len(rows[0]), len(rows[1]))
    bits = [np.unpackbits(np.stack([r[k] for k in shared]).view(np.uint8),
                          axis=1) for r in rows]
    same = float((bits[0] == bits[1]).mean())
    rows_same = float((bits[0] == bits[1]).all(1).mean())
    return len(rows[0]), len(rows[1]), overlap, same, rows_same


def phase_orb(frames, dev, smi, popc_rate):
    """The 752x480 sequence through FrontendParams(method="orb")."""
    orb = visual_frontend.FrontendParams(method="orb")
    n_card, n_cpu, overlap, same, rows_same = _orb_bank_agreement(
        frames[1], dev, orb)
    check(overlap >= ORB_AGREE and same >= ORB_AGREE,
          f"orb: card vs CPU keypoint overlap {overlap:.4f}, rBRIEF bits "
          f"equal {same:.5f} (>= {ORB_AGREE})")
    # the top-2 at ORB's W = 8 on two consecutive frames' banks
    _, d_prev, _ = visual_frontend.detect_and_describe(
        torch.as_tensor(frames[0], device=dev), orb)
    _, d_curr, m_curr = visual_frontend.detect_and_describe(
        torch.as_tensor(frames[1], device=dev), orb)
    check(d_curr.shape == (512, 8), f"orb: bank of shape {d_curr.shape}")
    stats = {"mismatches": 0, "max_abs_err": 0.0}
    _exact("orb: top-2 512x512x8", hamming.hamming_top2(d_prev, d_curr, m_curr),
           hamming.hamming_top2_reference(d_prev, d_curr, m_curr), stats)
    ops = (d_prev, d_curr, m_curr)
    ms = _time_calls(hamming.hamming_top2, [ops], 50)
    plain_ms = _time_calls(hamming.hamming_top2_reference, [ops], 50)
    bound_ms, bound_by = bound(2 * 512 * 8 * 4 + 512 + 3 * 512 * 4,
                               512 * 512 * 8, popc_rate)

    def run(plain):
        with _top2(plain):
            return _synced(lambda: visual_frontend.track_sequence(
                frames, params=orb, generator=_gen(dev, 0), device=dev))

    reset_launches()
    tracks, dt = run(plain=False)
    counts = launch_counts()
    want = dict(dense_g_a_window=0, seg_reduce_sorted=0, seg_broadcast=0,
                hamming_top2=len(frames), hamming_distance=0, pcg_trip=0,
                schur_self_blocks=0)
    check(counts == want, f"orb: launches {counts}, expected {want}")
    tracks_p, dt_p = run(plain=True)
    check(np.array_equal(tracks, tracks_p), "orb: tracks with the top-2 "
          "kernel and with its plain version differ")
    rows, n_ids, mean_len = _track_stats(tracks)
    check(n_ids >= ORB_MIN_IDS and mean_len >= ORB_MIN_MEAN_LENGTH,
          f"orb: {n_ids} track ids (>= {ORB_MIN_IDS}), mean length "
          f"{mean_len:.3f} (>= {ORB_MIN_MEAN_LENGTH})")

    img = torch.as_tensor(frames[1], device=dev).to(torch.float32)
    det = detect_orb_pyramid(img, orb.orb)
    state = visual_frontend._frontend_step(
        tracker_init(orb.tracker, 8, device=dev),
        torch.as_tensor(frames[0], device=dev), 0.0, _gen(dev, 1), orb)
    gen = _gen(dev, 2)
    layers = {
        "pyramid + detect": lambda: detect_orb_pyramid(img, orb.orb),
        "describe (pyramid + rBRIEF)": lambda: orb_describe_pyramid(
            img, det[0], det[2], det[3], det[4], orb.orb.scale_factor,
            orb.orb.num_levels, orb.orb_desc),
        "top-2 match": lambda: hamming.hamming_top2(d_prev, d_curr, m_curr),
        "whole frame step": lambda: visual_frontend._frontend_step(
            state, torch.as_tensor(frames[1], device=dev), 1.0, gen, orb),
    }
    parts = "; ".join(f"{k} {_median_ms(fn, 10):.3f}"
                      for k, fn in layers.items())
    print(f"orb: one 752x480 frame, FrontendParams(method='orb'): {n_card} "
          f"keypoints on the card, {n_cpu} on the CPU, overlap {overlap:.4f}; "
          f"rBRIEF bits of the shared ones equal {same:.5f} (rows "
          f"{rows_same:.4f}; bound {ORB_AGREE})")
    print(f"orb: top-2 512x512x8 equals its plain version exactly; "
          f"{ms:.4f} ms (kernel) vs {plain_ms:.4f} ms (plain); bound "
          f"{bound_ms:.6f} ms ({bound_by}), device time | {smi}")
    print(f"orb: {len(frames)} frames tracked: launches {counts} (1 top-2 per "
          f"frame), tracks identical to the plain top-2 run: {rows} rows, "
          f"{n_ids} ids (>= {ORB_MIN_IDS}), mean length {mean_len:.3f} (>= "
          f"{ORB_MIN_MEAN_LENGTH}); {len(frames) / dt:.3f} frames/s with the "
          f"kernel, {len(frames) / dt_p:.3f} with the plain top-2 | {smi}")
    print(f"orb: ms per 752x480 frame by layer: {parts} | {smi}")
    stats.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by)
    return stats


def _planted(rng, n_train, n_query, replace):
    """bench.py's bench_lsh banks: numpy uint32 words, queries are train rows
    (drawn with or without replacement) with LSH_FLIPS random bits
    flipped, in bench.py's order of draws."""
    d2 = rng.integers(0, 2**32, (n_train, LSH_WORDS), dtype=np.uint32)
    if replace:
        src = rng.integers(0, n_train, n_query)
        d1 = d2[src].copy()
        flips = rng.integers(0, LSH_WORDS * 32, (n_query, LSH_FLIPS))
    else:
        src = rng.choice(n_train, n_query, replace=False)
        d1 = d2[src].copy()
        flips = np.stack([rng.integers(0, LSH_WORDS * 32, LSH_FLIPS)
                          for _ in range(n_query)])
    rows = np.repeat(np.arange(n_query), LSH_FLIPS)
    bits = flips.reshape(-1)
    np.bitwise_xor.at(d1, (rows, bits // 32),
                      np.left_shift(np.uint32(1), (bits % 32).astype(np.uint32)))
    return d1, d2, src


def _popcount_oracle(d1, d2):
    """Exact nearest train row (first of equals) of every query, by XOR and
    a numpy byte popcount on the host."""
    table = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    out = np.empty(len(d1), np.int64)
    for lo in range(0, len(d1), 16):
        x = np.bitwise_xor(d1[lo:lo + 16, None, :], d2[None, :, :])
        counts = table[x.view(np.uint8)].sum(-1, dtype=np.int32)
        out[lo:lo + 16] = counts.argmin(1)
    return out


def _index_equal(a, b):
    return (torch.equal(a.sorted_ids.cpu(), b.sorted_ids)
            and torch.equal(a.offsets.cpu(), b.offsets))


def phase_lsh(dev, smi):
    """bench.py's two LSH configurations."""
    rng = np.random.default_rng(3)
    d1, d2, src = _planted(rng, LSH_N, LSH_N, replace=True)
    p = flann.FLANNParams(bucket_capacity=32)
    t1, t2 = (torch.as_tensor(x.view(np.int32), device=dev) for x in (d1, d2))
    m = torch.ones(LSH_N, dtype=torch.bool, device=dev)
    reset_launches()
    index = flann.build_lsh_index(t2, m, p)
    idx2, valid, diag = flann.lsh_match(t1, m, index, p)
    counts = launch_counts()
    check(not any(counts.values()), f"lsh: the LSH path launched {counts}")
    cpu_index = flann.build_lsh_index(t2.cpu(), m.cpu(), p)
    check(_index_equal(index, cpu_index), "lsh: the card's index differs "
          "from the CPU's")
    idx_c, valid_c, _ = flann.lsh_match(t1.cpu(), m.cpu(), cpu_index, p)
    check(torch.equal(idx2.cpu(), idx_c) and torch.equal(valid.cpu(), valid_c),
          "lsh: the card's matches differ from the CPU's")
    recall = float(((idx2.cpu().numpy() == src) & valid.cpu().numpy()).mean())
    build_s = np.median([_synced(lambda: flann.build_lsh_index(t2, m, p))[1]
                         for _ in range(3)])
    query_s = np.median([_synced(lambda: flann.lsh_match(t1, m, index, p))[1]
                         for _ in range(3)])
    # the exact yardstick: the top-2 kernel at 16,384^2 x 16
    stats = {"mismatches": 0, "max_abs_err": 0.0}
    reset_launches()
    exact = hamming.hamming_top2(t1, t2, m)
    check(launch_counts()["hamming_top2"] == 1, "lsh: no top-2 launch")
    _exact("lsh: top-2 16384x16384x16", exact,
           hamming.hamming_top2_reference(t1, t2, m), stats)
    exact_ms = _time_calls(hamming.hamming_top2, [(t1, t2, m)], 5)
    exact_recall = float((exact[2].cpu().numpy() == src).mean())
    print(f"lsh: {LSH_N}x{LSH_N}x{LSH_WORDS} planted banks ({LSH_FLIPS} "
          f"flips), FLANNParams(bucket_capacity=32): index built in "
          f"{build_s:.4f} s, equal to the CPU's bit for bit, as are the "
          f"matches; {LSH_N / query_s:.0f} matches/s, recall of the planted "
          f"rows {recall:.4f}, mean candidates "
          f"{float(diag['num_candidates'].float().mean()):.1f}; no package "
          f"kernel launched | {smi}")
    print(f"lsh: exact yardstick, the top-2 kernel at "
          f"{LSH_N}x{LSH_N}x{LSH_WORDS}: equal to its plain version, "
          f"{exact_ms:.4f} ms device time (LSH query {1e3 * query_s:.4f} ms "
          f"of wall: {exact_ms / (1e3 * query_s):.3f}x), nearest-row recall "
          f"{exact_recall:.4f} | {smi}")

    d1q, d2m, src2 = _planted(rng, LSH_MAP, LSH_QUERIES, replace=False)
    xyq = torch.as_tensor(rng.uniform(0, 752, (LSH_QUERIES, 2)).astype(
        np.float32), device=dev)
    xym = torch.as_tensor(rng.uniform(0, 752, (LSH_MAP, 2)).astype(
        np.float32), device=dev)
    q, mp_bank = (torch.as_tensor(x.view(np.int32), device=dev)
                  for x in (d1q, d2m))
    mq = torch.ones(LSH_QUERIES, dtype=torch.bool, device=dev)
    mm = torch.ones(LSH_MAP, dtype=torch.bool, device=dev)
    mp = matcher.MatcherParams(method="lsh", auto_remove_outliers=False)
    reset_launches()
    (i65, v65, d65), dt65 = _synced(lambda: matcher.match_descriptors(
        q, mp_bank, xyq, xym, mq, mm, None, mp))
    check(not any(launch_counts().values()), "lsh: the relocalization "
          "launched a package kernel")
    i65c, v65c, _ = matcher.match_descriptors(
        q.cpu(), mp_bank.cpu(), xyq.cpu(), xym.cpu(), mq.cpu(), mm.cpu(),
        None, mp)
    check(torch.equal(i65.cpu(), i65c) and torch.equal(v65.cpu(), v65c),
          "lsh: the 65,536 relocalization differs from the CPU's")
    check(_index_equal(flann.build_lsh_index(mp_bank, mm, flann.FLANNParams()),
                       flann.build_lsh_index(mp_bank.cpu(), mm.cpu(),
                                             flann.FLANNParams())),
          "lsh: the 65,536 index differs from the CPU's")
    i65, v65 = i65.cpu().numpy(), v65.cpu().numpy()
    oracle = _popcount_oracle(d1q, d2m)
    recall65 = float(((i65 == src2) & v65).mean())
    agree = float((i65[v65] == oracle[v65]).mean())
    check(recall65 > 0.5 and agree > 0.99, f"lsh: 65,536 map recall "
          f"{recall65:.4f}, agreement with the exact oracle {agree:.4f}")
    dt65 = np.median([dt65] + [_synced(lambda: matcher.match_descriptors(
        q, mp_bank, xyq, xym, mq, mm, None, mp))[1] for _ in range(2)])
    print(f"lsh: one {LSH_QUERIES}-keypoint frame against a {LSH_MAP} map "
          f"through MatcherParams(method='lsh'): {1 / dt65:.2f} frames/s "
          f"(index build included), recall of the planted rows "
          f"{recall65:.4f}, agreement with the exact numpy oracle {agree:.4f}"
          f"; matches and index equal to the CPU's | {smi}")
    return stats


def phase_vo_pair(dev, smi):
    """two_frame_pose on frames 0 and 2 of the orb sequence."""
    a, b, K, R_true = bench_frontend.vo_pair(bench_frontend.EUROC_FRONTEND,
                                             seed=0, i=0, j=2)
    img1, img2 = (torch.as_tensor(x, device=dev) for x in (a, b))
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    reset_launches()
    results, times = [], []
    for s in range(VO_SEEDS):
        res, dt = _synced(lambda: vo_frontend.two_frame_pose(
            img1, img2, Kt, _gen(dev, s)))
        results.append(res)
        times.append(dt)
    counts = launch_counts()
    check(counts["hamming_top2"] == VO_SEEDS
          and counts["hamming_distance"] == 0,
          f"vo_pair: launches {counts} in {VO_SEEDS} pairs")
    errs = [bench_frontend.rotation_error(r.T_21.rotation().cpu().numpy(),
                                          R_true) for r in results]
    med = float(np.median(errs))
    check(med <= 1.5 * JAX_VO_ROT_ERR + 1e-3, f"vo_pair: median rotation "
          f"error {med} rad against the JAX package's {JAX_VO_ROT_ERR}")
    with _top2(plain=True):
        plain = vo_frontend.two_frame_pose(img1, img2, Kt, _gen(dev, 0))
    check(torch.equal(plain.inliers, results[0].inliers),
          "vo_pair: the plain top-2 gives other inliers")
    _, syncs = _sync_free(lambda: vo_frontend.two_frame_pose(
        img1, img2, Kt, _gen(dev, 0)))
    sites = collections.Counter()
    for k, v in syncs.items():
        sites[f"{Path(k).name}:{k.rsplit(':', 1)[1]}"] += v
    print(f"vo_pair: frames 0 and 2 (752x480, true rotation "
          f"{bench_frontend.rotation_error(np.eye(3), R_true):.4f} rad) "
          f"through two_frame_pose, {VO_SEEDS} generators: launches {counts} "
          f"(1 top-2 per pair); rotation error median {med:.5f} rad (runs "
          f"{', '.join(f'{e:.4f}' for e in errs)}; the JAX package's median "
          f"{JAX_VO_ROT_ERR:.5f}, bound 1.5x + 1e-3); "
          f"{int(results[0].diagnostics['num_good_matches'])} ratio-test "
          f"matches, {int(results[0].inliers.sum())} inliers; "
          f"{1e3 * np.median(times):.3f} ms per pair; synchronizing calls "
          f"per pair {sum(sites.values())}: "
          f"{', '.join(f'{k} x{v}' for k, v in sorted(sites.items()))} | "
          f"{smi}")
    return counts


def phase_batched(frames, dev, smi):
    """B copies of the orb sequence through track_sequences_batched."""
    params = visual_frontend.FrontendParams()
    stack = np.stack([frames] * BATCH)
    T = len(frames)
    reset_launches()
    out, dt_b = _synced(lambda: visual_frontend.track_sequences_batched(
        stack, params=params, device=dev,
        generators=[_gen(dev, b) for b in range(BATCH)]))
    counts = launch_counts()
    want = dict(dense_g_a_window=0, seg_reduce_sorted=0, seg_broadcast=0,
                hamming_top2=BATCH * T, hamming_distance=0, pcg_trip=0,
                schur_self_blocks=0)
    check(counts == want, f"batched: launches {counts}, expected {want}")
    singles = []
    for b in range(BATCH):
        one, dt = _synced(lambda: visual_frontend.track_sequence(
            frames, params=params, generator=_gen(dev, b), device=dev))
        check(np.array_equal(out[b], one), f"batched: sequence {b}'s tracks "
              f"({len(out[b])} rows) differ from track_sequence's "
              f"({len(one)} rows)")
        singles.append(dt)
    _, dt_b2 = _synced(lambda: visual_frontend.track_sequences_batched(
        stack, params=params, device=dev,
        generators=[_gen(dev, b) for b in range(BATCH)]))
    dt_b = min(dt_b, dt_b2)
    rows = [len(t) for t in out]
    print(f"batched: {BATCH} copies of the {T}-frame 752x480 sequence, "
          f"FrontendParams(), one generator each: launches {counts} (the "
          f"top-2 once per sequence per frame); every sequence's tracks equal "
          f"track_sequence's with its generator ({min(rows)}-{max(rows)} "
          f"rows); {BATCH * T / dt_b:.3f} frames/s aggregate against "
          f"{T / np.median(singles):.3f} one sequence at a time "
          f"({np.median(singles) * BATCH / dt_b:.3f}x) | {smi}")
    return counts


# ---------------------------------------------------------------------------
# The trajectory back end and the leaves (gps_trajectory, nlls, float_flann,
# leaves)
# ---------------------------------------------------------------------------


def _traces_close(what, got, ref, rtol):
    """Cost traces within ``rtol`` (costs at rounding level, below 1e-20 of
    the largest, within that)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    floor = 1e-20 * float(ref.abs().max())
    err = (got - ref).abs() - rtol * ref.abs()
    check(bool((err <= floor).all()), f"{what}: cost trace {got.tolist()} "
          f"against {ref.tolist()} (rtol {rtol})")
    return float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max())


def _max_gap(a, b):
    return float((a.detach().double().cpu() - b.detach().double().cpu())
                 .abs().max())


def phase_gps_trajectory(dev, smi):
    """The GPS/INS smoother: LLH fixes -> ENU -> MeasurementBuffer ->
    GPS-with-bias, motion and decaying-bias banks -> solve_trajectory_gn."""
    truth = bench_trajectory.gps_truth()
    llh = bench_trajectory.gps_fixes(truth)  # written on the host, f64
    T = llh.shape[0]

    def build():
        enu = bench_trajectory.gps_fixes_enu(llh, dev)
        return enu, bench_trajectory.gps_problem(truth, enu)

    (enu, (state0, fns, ok)), t_build = _synced(build)
    check(bool(ok.all().cpu()), "gps_trajectory: a state's fix was not "
          "found in the measurement buffer")
    enu_gap = _max_gap(enu, bench_trajectory.gps_fixes_enu(llh, "cpu"))
    check(enu_gap <= LEAF_M_TOL, f"gps_trajectory: the fixes' ENU on the "
          f"card {enu_gap} m from the CPU's")
    iters = bench_trajectory.GPS_ITERS

    def solve(n=iters):
        return factors.solve_trajectory_gn(state0, fns, num_iters=n)

    solve(1)  # first use: torch.func's set-up
    torch.cuda.reset_peak_memory_stats(dev)
    ((out, info), wall), syncs = _sync_free(lambda: _synced(solve))
    check(not syncs, f"gps_trajectory: synchronizing calls in the LM solve: "
          f"{dict(syncs)}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_iter = _busy(lambda: solve(2))[3] - _busy(lambda: solve(1))[3]
    # the port's CPU solve of the same arrays (the card's fixes)
    state_c, fns_c, _ = bench_trajectory.gps_problem(truth, enu.cpu())
    (out_c, info_c), wall_c = _synced(
        lambda: factors.solve_trajectory_gn(state_c, fns_c, num_iters=iters))
    rel = _traces_close("gps_trajectory: card vs CPU", info["costs"],
                        info_c["costs"], GPS_CPU_RTOL)
    gaps = {f: _max_gap(getattr(out, f), getattr(out_c, f))
            for f in out._fields}
    check(max(gaps.values()) <= GPS_STATE_TOL, f"gps_trajectory: card vs "
          f"CPU states {gaps}")
    final = float(info["final_cost"])
    initial = float(info["initial_cost"])
    jax_rel = abs(final - JAX_GPS_FINAL_COST) / JAX_GPS_FINAL_COST
    check(final < initial and jax_rel <= GPS_JAX_RTOL,
          f"gps_trajectory: final cost {final} (initial {initial}), the JAX "
          f"package's {JAX_GPS_FINAL_COST}")
    err = bench_trajectory.gps_errors(out, truth)
    err0 = bench_trajectory.gps_errors(state0, truth)
    print(f"gps_trajectory: {T} states at 10 Hz (tangent {T * out.DIM}), "
          f"fixes as LLH -> ENU -> MeasurementBuffer -> 5 factor banks, "
          f"built on the card in {t_build:.3f} s (ENU {enu_gap:.2e} m from "
          f"the CPU's); {iters} LM iterations at f64 under sync debug "
          f"mode, no synchronizing call: cost {initial:.9e} -> {final:.17e} (the JAX package's "
          f"{JAX_GPS_FINAL_COST:.17e}, rel {jax_rel:.2e}); card vs CPU: "
          f"costs rel {rel:.2e}, states {max(gaps.values()):.2e}; position "
          f"error {err['position_m']:.4f} m (start {err0['position_m']:.4f})"
          f", bias error {err['bias_m']:.4f} m (start {err0['bias_m']:.4f}); "
          f"{1e3 * wall / iters:.3f} ms per LM iteration (CPU "
          f"{1e3 * wall_c / iters:.1f}), {per_iter} CUDA kernels per "
          f"iteration, peak allocation {peak:.3f} GiB | {smi}")


def _curve_solve(X, Y, jac, dev):
    p0 = torch.zeros(2, dtype=torch.float64, device=dev)
    cfg = nlls.LMConfig(max_iterations=bench_trajectory.CURVE_ITERS)
    if Y.dim() == 1:
        return nlls.lm_solve(nlls.exp_curve_residual, p0, args=(X, Y),
                             jac=jac, config=cfg)
    return torch.func.vmap(lambda yy: nlls.lm_solve(
        nlls.exp_curve_residual, p0, args=(X, yy), jac=jac, config=cfg))(Y)


def _curve_jacobian(p, x, y):
    e = torch.exp(p[0] * x + p[1])
    return torch.stack([-x * e, -e], dim=-1)


def _fit_held(what, res, ref):
    rel = _traces_close(what, res.cost_trace, ref.cost_trace, NLLS_RTOL)
    gap = _max_gap(res.x, ref.x)
    check(gap <= NLLS_X_TOL, f"{what}: x {gap} from the CPU's")
    m, c = (res.x[..., k].cpu() for k in range(2))
    dm, dc = (float((v - t).abs().max()) for v, t in (
        (m, bench_trajectory.CURVE_M), (c, bench_trajectory.CURVE_C)))
    check(dm < bench_trajectory.CURVE_BOUNDS[0]
          and dc < bench_trajectory.CURVE_BOUNDS[1],
          f"{what}: |m - 0.3| {dm}, |c - 0.1| {dc}")
    return rel, gap, dm, dc


def phase_nlls(dev, smi):
    """tests/test_nlls.py's exponential curve, three Jacobians, then a
    batch of fits under torch.func.vmap."""
    x, y = bench_trajectory.curve_batch(NLLS_BATCH)
    X, Y = (torch.as_tensor(a, device=dev) for a in (x, y))
    Xc, Yc = torch.as_tensor(x), torch.as_tensor(y)
    kinds = {"autodiff": None,
             "numeric": nlls.numeric_jacobian(nlls.exp_curve_residual),
             "analytic": _curve_jacobian}
    parts = []
    for kind, jac in kinds.items():
        _curve_solve(X, Y[0], jac, dev)
        (res, dt), syncs = _sync_free(
            lambda: _synced(lambda: _curve_solve(X, Y[0], jac, dev)))
        check(not syncs, f"nlls {kind}: synchronizing calls: {dict(syncs)}")
        ref = _curve_solve(Xc, Yc[0], jac, "cpu")
        rel, gap, _, _ = _fit_held(f"nlls {kind}", res, ref)
        parts.append(f"{kind} m {float(res.x[0]):.6f} c {float(res.x[1]):.6f}"
                     f" in {int(res.iterations)} steps, {1e3 * dt:.1f} ms "
                     f"(card vs CPU: costs rel {rel:.1e}, x {gap:.1e})")
    _curve_solve(X, Y[:8], None, dev)
    (res, dt), syncs = _sync_free(
        lambda: _synced(lambda: _curve_solve(X, Y, None, dev)))
    check(not syncs, f"nlls batch: synchronizing calls: {dict(syncs)}")
    ref, dt_c = _synced(lambda: _curve_solve(Xc, Yc, None, "cpu"))
    rel, gap, dm, dc = _fit_held("nlls batch", res, ref)
    print(f"nlls: the curve-fitting tutorial (68 points) under sync debug "
          f"mode, no synchronizing call: {'; '.join(parts)} | {smi}")
    print(f"nlls: {NLLS_BATCH} fits under torch.func.vmap, "
          f"{bench_trajectory.CURVE_ITERS} iterations, f64, no sync: "
          f"{NLLS_BATCH / dt:.1f} fits/s ({1e3 * dt:.1f} ms; CPU "
          f"{NLLS_BATCH / dt_c:.1f} fits/s); card vs CPU: costs rel "
          f"{rel:.1e}, x {gap:.1e}; every fit |m - 0.3| <= {dm:.4f}, "
          f"|c - 0.1| <= {dc:.4f} (bounds 0.02, 0.05); all converged "
          f"{bool(res.converged.all())} | {smi}")


def _float_oracle(d1, d2, rows=4096):
    """(argmin, clear) of an f64 L2 search on the card, in chunks of query
    rows: ``clear`` marks the rows whose best and second distances differ
    by more than 1e-5 of the best."""
    b = d2.double()
    bb = (b * b).sum(1)
    ids, clear = [], []
    for k in range(0, d1.shape[0], rows):
        a = d1[k:k + rows].double()
        d = (a * a).sum(1)[:, None] + bb[None] - 2.0 * a @ b.T
        s, i = torch.topk(d, 2, dim=1, largest=False)
        ids.append(i[:, 0])
        clear.append(s[:, 1] - s[:, 0] > 1e-5 * s[:, 0])
    return torch.cat(ids), torch.cat(clear)


def _kmeans_held(d2, m2, p, stats):
    """Build ``p``'s index with every k-means sum (``seg_reduce``) also
    run through its plain version on the same inputs, equal bit for
    bit."""
    def held(vals, idx, num_segments):
        got = segmm.seg_reduce(vals, idx, num_segments)
        ref = segmm.seg_reduce_reference(vals, idx, num_segments)
        check(torch.equal(got, ref), f"float_flann: seg_reduce call "
              f"{stats['calls']} differs from its plain version by "
              f"{_max_gap(got, ref)}")
        stats["calls"] += 1
        return got

    view = types.SimpleNamespace(**{**vars(segmm), "seg_reduce": held})
    with mock.patch.object(flann_float, "segmm", view):
        return flann_float.build_float_index(d2, m2, p)


def phase_float_flann(dev, smi):
    """Planted SIFT-like banks through the float indexes."""
    FP = flann_float.FloatIndexParams
    d1, d2, src = bench_trajectory.planted_float(
        np.random.default_rng(bench_trajectory.FLANN_SEED),
        n_train=FLANN_N, n_query=FLANN_N)
    D1, D2 = (torch.as_tensor(a, device=dev) for a in (d1, d2))
    m1 = m2 = torch.ones(FLANN_N, dtype=torch.bool, device=dev)
    src_t = torch.as_tensor(src, device=dev)
    oracle, clear = _float_oracle(D1, D2)
    p = FP(method="exact")
    index = flann_float.build_float_index(D2, m2, p)
    flann_float.float_match(D1, m1, index, p)
    (idx, _, _), dt = _synced(lambda: flann_float.float_match(D1, m1, index,
                                                              p))
    wrong = int(((idx.long() != oracle) & clear).sum())
    check(wrong == 0, f"float_flann: exact differs from the f64 oracle in "
          f"{wrong} clear rows")
    lines = [f"exact {FLANN_N / dt:.4e} matches/s, equal to the f64 oracle "
             f"in all {int(clear.sum())} clear rows (of {FLANN_N}), recall "
             f"{float((idx == src_t).double().mean()):.4f}"]
    for cfg, extra in (("test", {}), ("bits9", {"key_bits": 9})):
        for method in ("kdtree", "kmeans", "composite"):
            p = FP(method=method, **{**bench_trajectory.FLANN_TEST, **extra})
            reset_launches()
            index, t_build = _synced(
                lambda: flann_float.build_float_index(D2, m2, p))
            counts = launch_counts()
            want = p.kmeans_iterations if method != "kdtree" else 0
            check(counts["seg_reduce_sorted"] == want
                  and sum(counts.values()) == want,
                  f"float_flann {cfg} {method}: launches {counts}, want "
                  f"{want} seg_reduce")
            flann_float.float_match(D1, m1, index, p)
            (idx, _, diag), dt = _synced(
                lambda: flann_float.float_match(D1, m1, index, p))
            recall = float((idx == src_t).double().mean())
            cand = int(diag["num_candidates"].max())
            anchor = JAX_FLANN_RECALL[f"{cfg}_16384/{method}"]
            check(abs(recall - anchor) <= 0.01 and cand < FLANN_N,
                  f"float_flann {cfg} {method}: recall {recall} (the JAX "
                  f"package's {anchor}), candidates up to {cand}")
            if cfg == "bits9":
                floor = bench_trajectory.RECALL_FLOORS[method]
                check(recall > floor, f"float_flann bits9 {method}: recall "
                      f"{recall} under the JAX test's floor {floor}")
            held = ""
            if want:
                stats = {"calls": 0}
                again = _kmeans_held(D2, m2, p, stats)
                check(stats["calls"] == want
                      and torch.equal(again.centroids, index.centroids),
                      f"float_flann {cfg} {method}: {stats['calls']} held "
                      f"calls; centroids equal on a second build: "
                      f"{torch.equal(again.centroids, index.centroids)}")
                held = (f", {want} seg_reduce launches held to the plain "
                        f"version bit for bit, a second build's centroids "
                        f"equal bit for bit")
            lines.append(f"{cfg} {method} (key_bits {p.key_bits}): recall "
                         f"{recall:.4f} (JAX {anchor:.4f}), candidates up to "
                         f"{cand}, build {t_build:.3f} s, {FLANN_N / dt:.4e} "
                         f"matches/s{held}")
    # tests/test_flann.py's own size, against the JAX package's recall
    s1, s2, ssrc = bench_trajectory.planted_float(
        np.random.default_rng(bench_trajectory.FLANN_SEED))
    S1, S2 = (torch.as_tensor(a, device=dev) for a in (s1, s2))
    for method in ("kdtree", "kmeans", "composite"):
        p = FP(method=method, **bench_trajectory.FLANN_TEST)
        index = flann_float.build_float_index(
            S2, torch.ones(2048, dtype=torch.bool, device=dev), p)
        idx, _, _ = flann_float.float_match(
            S1, torch.ones(256, dtype=torch.bool, device=dev), index, p)
        recall = float((idx.cpu().numpy() == ssrc).mean())
        anchor = JAX_FLANN_RECALL[f"test_2048/{method}"]
        check(abs(recall - anchor) <= 0.01
              and recall > bench_trajectory.RECALL_FLOORS[method],
              f"float_flann 2048 {method}: recall {recall}, the JAX "
              f"package's {anchor}")
        lines.append(f"2048/256 {method} recall {recall:.4f} (JAX "
                     f"{anchor:.4f})")
    print(f"float_flann: planted {FLANN_N} x {FLANN_N} x 128 f32 banks: "
          f"{'; '.join(lines)} | {smi}")


def _held_cpu(what, card, cpu, tol):
    gap = max(_max_gap(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(card),
        torch.utils._pytree.tree_leaves(cpu)))
    check(gap <= tol, f"leaves {what}: card vs CPU {gap} (tolerance {tol})")
    return gap


def _both(fn, dev):
    """``fn(device)`` on the card ``dev`` (synchronized, timed) and on the
    CPU."""
    card, dt = _synced(lambda: fn(dev))
    return card, dt, fn(torch.device("cpu"))


def _geodesy(llh, dev):
    llh = torch.as_tensor(llh, device=dev)
    ecef = world_frame.ecef_point_from_llh(llh)
    back = world_frame.llh_point_from_ecef(ecef)
    enu = world_frame.enu_point_from_llh(llh, bench_trajectory.DATUM_LLH)
    return ecef, back, enu, world_frame.llh_point_from_enu(
        enu, bench_trajectory.DATUM_LLH)


def _buffer_reads(rec, reads, dev):
    times, sensors, values = (torch.as_tensor(a, device=dev) for a in rec)
    buf = measurement.insert_batch(
        measurement.measurement_buffer(times.shape[0], values.shape[1],
                                       torch.float64, dev),
        times, sensors, values)
    out = [measurement.get_interpolated(
        buf, torch.as_tensor(r, device=dev), s) for s, r in enumerate(reads)]
    return [v for v, _ in out], [ok for _, ok in out], buf


def _oracle_reads(rec, reads):
    """numpy: each sensor's records sorted by time, the bracketing pair by
    searchsorted, the linear blend (exact records read back as stored)."""
    times, sensors, values = rec
    vals, oks = [], []
    for s, r in enumerate(reads):
        t, v = times[sensors == s], values[sensors == s]
        order = np.argsort(t)
        t, v = t[order], v[order]
        hi = np.clip(np.searchsorted(t, r, side="left"), 0, len(t) - 1)
        lo = np.clip(np.searchsorted(t, r, side="right") - 1, 0, len(t) - 1)
        ok = (r >= t[0]) & (r <= t[-1])
        den = t[hi] - t[lo]
        w = np.where(den > 0, (r - t[lo]) / np.where(den == 0, 1.0, den), 0.0)
        vals.append(v[lo] + w[:, None] * (v[hi] - v[lo]))
        oks.append(ok)
    return vals, oks


def _pose_chain(steps, covs, dev):
    q, t = (torch.as_tensor(a, device=dev) for a in steps)
    c = torch.as_tensor(covs, device=dev)
    acc = pose_cov.PoseWithCovariance.certain(
        SE3.identity(dtype=torch.float64, device=dev))
    for k in range(q.shape[0]):
        acc = pose_cov.compose_pose_with_covariance(
            acc, pose_cov.PoseWithCovariance(SE3(q=q[k], t=t[k]), c[k]))
    return acc


def _hover(dev):
    p = kinematics.QuadrotorParams()
    s = kinematics.quadrotor_init(LEAF_HOVER_START, torch.float64, dev)
    target = torch.as_tensor(LEAF_HOVER_TARGET, dtype=torch.float64,
                             device=dev)
    yaw = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(LEAF_HOVER_STEPS):
        s = kinematics.quadrotor_step(p, s, target, yaw, LEAF_HOVER_DT)
    return s


def _gimbal(targets, dev):
    p = kinematics.GimbalParams(camera_offset_rpy=(0.05, -0.02, 0.1))
    s = kinematics.gimbal_init(torch.float64, dev)
    targets = torch.as_tensor(targets, device=dev)
    for k in range(LEAF_GIMBAL_STEPS):
        if k % 10 == 0:  # the camera's 100 Hz target updates
            s = kinematics.gimbal_track_target(p, s, targets[k // 10])
        motors, s = gimbal.gimbal_attitude_control(s, 0.001)
        s = kinematics.gimbal_step(p, s, motors, 0.001)
    return s


@dataclasses.dataclass(frozen=True)
class _Camera:
    name: str = "cam0"
    K: np.ndarray = utils_config.config_field(None)
    rate_hz: float = 20.0


@dataclasses.dataclass(frozen=True)
class _Rig:
    camera: _Camera = dataclasses.field(default_factory=_Camera)
    matcher: flann_float.FloatIndexParams = dataclasses.field(
        default_factory=flann_float.FloatIndexParams)
    frames: int = utils_config.config_field(0, required=True)


def phase_leaves(dev, smi):
    """The geodesy, container, pose-covariance, simulator and config
    leaves on the card against the same on the CPU."""
    rng = np.random.default_rng(LEAF_SEED)
    lines = []
    llh = np.stack([rng.uniform(-85, 85, LEAF_POINTS),
                    rng.uniform(-180, 180, LEAF_POINTS),
                    rng.uniform(-100, 9000, LEAF_POINTS)], axis=-1)
    card, dt, cpu = _both(lambda d: _geodesy(llh, d), dev)
    ecef, back, enu, back2 = card
    gaps = [_held_cpu("ECEF", ecef, cpu[0], LEAF_M_TOL),
            _held_cpu("ENU", enu, cpu[2], LEAF_M_TOL)]
    for b, bc in ((back, cpu[1]), (back2, cpu[3])):
        gaps.append(_held_cpu("LLH degrees", b[:, :2], bc[:, :2],
                              LEAF_F64_TOL))
        gaps.append(_held_cpu("LLH height", b[:, 2], bc[:, 2], LEAF_M_TOL))
    trip = _max_gap(back[:, :2], torch.as_tensor(llh[:, :2]))
    check(trip <= 1e-9, f"leaves: LLH round trip {trip} degrees")
    lines.append(f"world_frame: {LEAF_POINTS} LLH points f64 to ECEF and "
                 f"back, and to ENU and back, in {1e3 * dt:.2f} ms (round "
                 f"trip {trip:.1e} deg; card vs CPU {max(gaps):.1e})")

    times = np.sort(rng.uniform(0, 600, LEAF_RECORDS))
    sensors = rng.integers(0, 4, LEAF_RECORDS).astype(np.int32)
    values = rng.normal(size=(LEAF_RECORDS, 3))
    rec = (times, sensors, values)
    reads = [np.concatenate([times[sensors == s][:64], rng.uniform(
        -1, 601, LEAF_RECORDS // 4 - 64)]) for s in range(4)]
    (vals, oks, buf), dt = _synced(lambda: _buffer_reads(rec, reads, dev))
    few = [r[:LEAF_CPU_READS] for r in reads]
    vals_c, oks_c, _ = _buffer_reads(rec, few, "cpu")
    ovals, ooks = _oracle_reads(rec, reads)
    for s in range(4):
        check(torch.equal(oks[s][:LEAF_CPU_READS].cpu(), oks_c[s])
              and np.array_equal(oks[s].cpu().numpy(), ooks[s]),
              f"leaves: sensor {s}'s ok flags differ")
    gap = max(_held_cpu("reads", v[:LEAF_CPU_READS], vc, LEAF_F64_TOL)
              for v, vc in zip(vals, vals_c))
    ogap = max(_max_gap(v[ok], torch.as_tensor(o)[ok.cpu()])
               for v, o, ok in zip(vals, ovals, oks))
    check(ogap <= LEAF_F64_TOL, f"leaves: reads {ogap} from the numpy "
          f"oracle")
    check(int(measurement.size(buf)) == LEAF_RECORDS, "leaves: buffer size")
    lines.append(f"measurement: {LEAF_RECORDS} records of 4 sensors, "
                 f"{sum(len(r) for r in reads)} interpolated reads in "
                 f"{1e3 * dt:.1f} ms (the first {LEAF_CPU_READS} a sensor "
                 f"against the CPU's {gap:.1e}; all against a numpy "
                 f"searchsorted oracle {ogap:.1e}, flags equal)")

    axis = rng.normal(size=(LEAF_CHAIN, 3)) * 0.02
    steps = (np.concatenate([np.ones((LEAF_CHAIN, 1)), 0.5 * axis], axis=1),
             rng.normal(size=(LEAF_CHAIN, 3)) * 0.1)
    steps = (steps[0] / np.linalg.norm(steps[0], axis=1, keepdims=True),
             steps[1])
    A = rng.normal(size=(LEAF_CHAIN, 6, 6)) * 1e-3
    covs = A @ np.swapaxes(A, -1, -2)
    card, dt, cpu = _both(lambda d: _pose_chain(steps, covs, d), dev)
    scale = float(cpu.cov.abs().max())
    gap = _held_cpu("pose chain", card, cpu, LEAF_F64_TOL * max(1.0, scale))
    lines.append(f"pose_cov: a chain of {LEAF_CHAIN} "
                 f"compose_pose_with_covariance steps in {dt:.2f} s "
                 f"({1e6 * dt / LEAF_CHAIN:.1f} us a step; final |t| "
                 f"{float(torch.linalg.vector_norm(card.pose.t)):.3f} m, "
                 f"max cov {scale:.3e}; card vs CPU {gap:.1e})")

    card, dt, cpu = _both(_hover, dev)
    gap = _held_cpu("quadrotor", card, cpu, LEAF_F64_TOL)
    miss = float(torch.linalg.vector_norm(card.position.cpu() - torch.as_tensor(
        LEAF_HOVER_TARGET)))
    targets = rng.normal(size=(LEAF_GIMBAL_STEPS // 10, 3)) + [0.0, 2.0, 1.0]
    gcard, gdt, gcpu = _both(lambda d: _gimbal(targets, d), dev)
    ggap = _held_cpu("gimbal", gcard, gcpu, LEAF_F64_TOL)
    lines.append(f"quadrotor: {LEAF_HOVER_STEPS} closed-loop steps of "
                 f"{LEAF_HOVER_DT} s in {dt:.2f} s ({1e3 * dt / LEAF_HOVER_STEPS:.3f}"
                 f" ms a step; {miss:.3f} m from the hover point; card vs CPU "
                 f"{gap:.1e}); gimbal: {LEAF_GIMBAL_STEPS} steps tracking "
                 f"{len(targets)} targets in {gdt:.2f} s (card vs CPU "
                 f"{ggap:.1e})")

    u = np.stack([rng.uniform(0.5, 1.5, LEAF_ROLLOUT),
                  rng.normal(0, 0.5, LEAF_ROLLOUT)], axis=-1)
    card, dt, cpu = _both(lambda d: kinematics.simulate_two_wheel(
        torch.zeros(3, dtype=torch.float64, device=d),
        torch.as_tensor(u, device=d), 0.01), dev)
    gap = _held_cpu("two-wheel", card, cpu, LEAF_F64_TOL)
    lines.append(f"two_wheel: a {LEAF_ROLLOUT}-step roll-out in {dt:.2f} s "
                 f"(card vs CPU {gap:.1e})")

    p = utils_config.from_dict(flann_float.FloatIndexParams,
                               {"method": "kmeans", "key_bits": 9})
    rig = utils_config.from_dict(_Rig, {"frames": 3, "camera": {
        "K": {"rows": 3, "cols": 3, "data": [458.0, 0, 367.0, 0, 457.0,
                                             248.0, 0, 0, 1]}},
        "matcher": {"method": "composite", "num_probes": 6}})
    check(p == flann_float.FloatIndexParams(method="kmeans", key_bits=9)
          and rig.camera.K.shape == (3, 3) and rig.camera.K[1, 2] == 248.0
          and rig.matcher.method == "composite" and rig.frames == 3,
          f"leaves: from_dict gave {p}, {rig}")
    lines.append(f"config: from_dict of FloatIndexParams and of a nested "
                 f"dataclass with a {{rows, cols, data}} matrix (PyYAML "
                 f"{'absent' if utils_config.yaml is None else 'present'})")
    print(f"leaves: {'; '.join(lines)} | {smi}")


# ---------------------------------------------------------------------------
# The distributed layer (parallel/*) on the one card: ranks are processes
# of this script (``--rank``), NCCL at one rank, gloo at 2 and 4 (NCCL puts
# one rank on a card; gloo stages CUDA tensors through the host). Times are
# of ranks sharing one card: they say nothing of scaling across cards.
# ---------------------------------------------------------------------------

DIST_TIMEOUT = 480  # s for one group of ranks, start-up included
DIST_GROUPS = ((1, "nccl", ("dist_ba",)),
               (2, "gloo", ("dist_ba", "dist_ba_f64", "dist_lm_step",
                            "dist_vio", "dist_pose_graph", "multi_match")),
               (4, "gloo", ("dist_ba", "dist_lm_step", "dist_pose_graph")))
# the one-step's (dp, tp) meshes at each number of ranks: the flat bank
# first (landmark rows whole on every rank), then landmark rows over tp
DIST_LM_MESHES = {2: ((2, 1), (1, 2)), 4: ((4, 1), (2, 2), (1, 4))}
DIST_PG_POSES = 1997  # not divisible by 2 or 4: both pad
DIST_PG_CFG = PoseGraphConfig(max_iterations=4, cg_max_iters=30)
# a few hundred landmarks at f64, CG run to convergence, so the card's and
# the CPU's sums part by rounding only
DIST_F64_PROBLEM = dict(num_poses=20, num_landmarks=300, obs_per_pose=30)
DIST_F64_CFG = dict(max_iterations=3, cg_max_iters=150, cg_tol=1e-12,
                    explicit_s="never")
# its costs card against CPU: rtol 1e-9 beside an atol of 1e-11 of the
# first iteration's cost, the level the LM's last, converged costs reach
# when two f64 summation orders part their states by ~1e-11 m (worst
# measured: the last cost 1.09e-8 of itself, about 3.8e-12 of the first
# cost; NVIDIA H100 80GB HBM3, 700 W)
DIST_F64_RTOL = 1e-9
DIST_F64_ATOL = 1e-11
# the sharded headline's f32 first iteration: within this many times the
# single-device solve's own gap between the card and the CPU, measured in
# the same run (the summation-order floor of 20 CG steps at f32)
DIST_F32_FLOOR_FACTOR = 3.0


def _dist_cfg():
    """The matrix-free headline configuration (10 LM iterations, 20 CG
    steps), the sharded solve's only route."""
    return dataclasses.replace(bench_problem.bench_config(LM_ITERS),
                               explicit_s="never")


@contextlib.contextmanager
def _timed_collectives(acc):
    """Time every collective of the mesh axes on the host clock, the card
    synchronized on both sides; ``acc`` gets the seconds and the count."""
    from libwave_tpu_torch.parallel.mesh import Axis

    def timed(fn):
        def call(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            acc["s"] += time.perf_counter() - t0
            acc["n"] += 1
            return out
        return call

    with mock.patch.object(Axis, "psum", timed(Axis.psum)), \
            mock.patch.object(Axis, "all_gather", timed(Axis.all_gather)):
        yield


def _to_f64(problem, state):
    """A BA problem and state with every floating field in f64."""
    problem = problem._replace(
        K=problem.K.double(), uv=problem.uv.double(),
        weight=problem.weight.double(), free_pose=problem.free_pose.double())
    return problem, ba.BAState(*(x.double() for x in state))


def _first_iteration_f64(problem, state, solve):
    """The first LM iteration's cost of ``solve`` (a BA solver taking
    problem, state and config) on the problem widened to f64."""
    cfg = dataclasses.replace(_dist_cfg(), max_iterations=1)
    _, info = solve(*_to_f64(problem, state), cfg)
    return float(info["costs"][0])


def _rank_dist_ba(mesh, dev, out):
    from libwave_tpu_torch.parallel import partition_ba_problem, \
        solve_ba_sharded

    problem, state = bench_problem.make_problem(device=dev)
    stacked, padded = partition_ba_problem(problem, state, mesh.size)
    cfg = _dist_cfg()

    def solve(c=cfg):
        res = solve_ba_sharded(stacked, padded, mesh, c)
        torch.cuda.synchronize()
        return res

    solve(dataclasses.replace(cfg, max_iterations=1))  # warm-up
    reset_launches()
    acc = {"s": 0.0, "n": 0}
    t0 = time.perf_counter()
    if mesh.backend == "nccl":
        # NCCL makes no host sync: the counted solve runs under sync debug
        # mode, and a second one times the collectives
        (st, info), syncs = _sync_free(solve)
        wall = time.perf_counter() - t0
        out["ba_counts"] = launch_counts()
        with _timed_collectives(acc):
            t0 = time.perf_counter()
            solve()
            wall_timed = time.perf_counter() - t0
    else:
        # gloo synchronizes at every collective already: one solve is
        # counted and timed
        with _timed_collectives(acc):
            st, info = solve()
        wall = wall_timed = time.perf_counter() - t0
        syncs = {}
        out["ba_counts"] = launch_counts()
    stats = {}
    with _held_to_plain(f"dist_ba at {mesh.size} ranks", stats):
        solve(dataclasses.replace(cfg, max_iterations=1))
    out["ba64_first"] = _first_iteration_f64(
        problem, state, lambda p, s, c: solve_ba_sharded(
            *partition_ba_problem(p, s, mesh.size), mesh, c))
    out.update(
        ba_costs=info["costs"].cpu().numpy(),
        ba_initial=float(info["initial_cost"]),
        ba_q=st.q.cpu().numpy(), ba_p=st.p.cpu().numpy(),
        ba_lm=st.lm.cpu().numpy(), ba_rate=LM_ITERS / wall,
        ba_syncs=dict(syncs), ba_collective_s=acc["s"],
        ba_collectives=acc["n"], ba_timed_wall=wall_timed,
        ba_held={k: (v["calls"], v["max_abs_err"]) for k, v in stats.items()})


def _rank_dist_ba_f64(mesh, dev, out):
    """A small f64 problem through the sharded solve on the card and on
    the CPU (a CPU mesh over the same gloo group)."""
    from libwave_tpu_torch.parallel import make_mesh, partition_ba_problem, \
        solve_ba_sharded

    cfg = dataclasses.replace(bench_problem.bench_config(), **DIST_F64_CFG)
    cpu_mesh = make_mesh(device="cpu")
    res = []
    for m in (mesh, cpu_mesh):
        problem, state = _to_f64(*bench_problem.make_problem(
            **DIST_F64_PROBLEM, device=m.device))
        st, info = solve_ba_sharded(
            *partition_ba_problem(problem, state, m.size), m, cfg)
        res.append((info["costs"].cpu().numpy(), st.p.cpu().numpy(),
                    st.lm.cpu().numpy()))
    out["f64_card"], out["f64_cpu"] = res


def _rank_dist_lm_step(mesh, dev, out):
    """``shard_ba_problem`` + ``distributed_lm_step`` on the headline
    problem at f64 on each (dp, tp) mesh of DIST_LM_MESHES: per mesh the
    cost, the poses, the rank's chunk and the gathered map, the counted
    step's launches and peak memory, the landmark-side bytes, and a second
    step with every reduce and broadcast call held to its plain version.
    Rank 0 also runs a local LM iteration."""
    from libwave_tpu_torch.parallel import MeshConfig, distributed_lm_step, \
        gather_landmarks, make_mesh, shard_ba_problem

    problem, state = _to_f64(*bench_problem.make_problem(device=dev))
    cfg = _dist_cfg()
    M = state.lm.shape[0]
    lam = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    for dp, tp in DIST_LM_MESHES[mesh.size]:
        m = mesh if tp == 1 else make_mesh(MeshConfig(dp=dp, tp=tp),
                                           device=dev)
        sharded, st = shard_ba_problem(problem, state, m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        new, cost = distributed_lm_step(sharded, st, cfg)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        whole = gather_landmarks(new, m, M)
        blocks = ba._linearize_ba(sharded.problem, st, lam, cfg.huber_delta,
                                  sharded.axes)
        stats = {}
        with _held_to_plain(f"dist_lm_step {dp}x{tp}", stats):
            distributed_lm_step(sharded, st, cfg)
        torch.cuda.synchronize()
        out[f"step_{dp}x{tp}"] = dict(
            cost=float(cost), q=new.q.cpu().numpy(), p=new.p.cpu().numpy(),
            chunk=new.lm.cpu().numpy(), lm=whole.cpu().numpy(),
            index=(m.axis("dp").index, m.axis("tp").index), counts=counts,
            held={k: v["calls"] for k, v in stats.items()}, peak=peak,
            lm_bytes=(st.lm.nbytes + blocks.Hll_inv.nbytes
                      + blocks.bl.nbytes),
            bank=int(sharded.problem.pose_idx.shape[0]))
        del sharded, st, new, whole, blocks
    if mesh.axis(mesh.axis_names).index == 0:
        carry = (state, lam, ba.ba_cost(problem, state),
                 torch.zeros((), dtype=torch.bool, device=dev))
        (local, _, cost, _), _ = ba._lm_iteration(problem, cfg, carry)
        out["step_local"] = dict(cost=float(cost), q=local.q.cpu().numpy(),
                                 p=local.p.cpu().numpy(),
                                 lm=local.lm.cpu().numpy())


def _rank_dist_vio(mesh, dev, out):
    from libwave_tpu_torch.parallel import partition_vio_problem, \
        solve_vio_sharded

    problem, gt, init = bench_problem.make_vio_problem(device=dev)
    cfg = bench_problem.vio_config("pcg")
    stacked, padded = partition_vio_problem(problem, init, mesh.size)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st, info = solve_vio_sharded(stacked, padded, mesh, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    N = gt.q.shape[0]
    out.update(vio_counts=launch_counts(),
               vio_costs=info["costs"].cpu().numpy(),
               vio_initial=float(info["initial_cost"]),
               vio_p=st.p.cpu().numpy(), vio_rate=N / wall, vio_N=N,
               vio_ate=_ate(gt, st._replace(q=st.q[:N], p=st.p[:N])),
               vio_ate0=_ate(gt, init))
    if mesh.axis("dp").index == 0:
        # through the plain matvec, as the sharded solve
        with mock.patch.object(schur, "_takes_fused_matvec",
                               return_value=False):
            _, ref = vio.solve_vio(problem, init, cfg)
        out["vio_single"] = ref["costs"].cpu().numpy()


def _rank_dist_pose_graph(mesh, dev, out):
    from libwave_tpu_torch.bench_parallel import circle_graph
    from libwave_tpu_torch.parallel import flatten_mesh, \
        partition_pose_graph, solve_pose_graph_blocks, unpartition

    _, _, q0, p0, between = circle_graph(DIST_PG_POSES, device=dev)
    g = partition_pose_graph(q0, p0, between, None, mesh.size)
    back = unpartition(g.q, g.p, DIST_PG_POSES)
    sp = flatten_mesh(mesh, "sp")
    solve_pose_graph_blocks(g, sp, DIST_PG_CFG._replace(
        max_iterations=1, cg_max_iters=2))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qb, pb, info = solve_pose_graph_blocks(g, sp, DIST_PG_CFG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    q, p = unpartition(qb, pb, DIST_PG_POSES)
    out.update(pg_trace=info["cost_trace"].cpu().numpy(),
               pg_p=p.cpu().numpy(), pg_q=q.cpu().numpy(), pg_wall=wall,
               pg_back=bool(torch.equal(back[0], q0)
                            and torch.equal(back[1], p0)),
               pg_seps=int(g.sep_mask.sum()))
    if sp.axis("sp").index == 0:
        _, p_ref, ref = solve_pose_graph(q0, p0, between, cfg=DIST_PG_CFG)
        out.update(pg_single=ref["cost_trace"].cpu().numpy(),
                   pg_single_p=p_ref.cpu().numpy())


def _pair_truth(q, p):
    """Each consecutive scan pair's true transform (ref scan t into target
    scan t+1 coordinates: the inverse of T_t^-1 T_{t+1}), f64 on the CPU."""
    T = SE3(q=torch.as_tensor(q), t=torch.as_tensor(p))
    a = SE3(q=T.q[:-1], t=T.t[:-1])
    b = SE3(q=T.q[1:], t=T.t[1:])
    return a.inverse().compose(b).inverse()


def _rank_multi_match(mesh, dev, out):
    from libwave_tpu_torch.matching.multi import multi_match, \
        multi_match_sharded

    pts, mask, q, p = bench_lidar.scan_sequence(ODOMETRY_T, 4096)
    _lidar_data("multi_match", "sequence", pts, mask)
    pts = torch.as_tensor(pts.astype(np.float32))
    mask = torch.as_tensor(mask)
    pairs = ODOMETRY_T - 1
    pad = (-pairs) % mesh.size

    def batch(x, fill):
        return torch.cat([x, fill.expand((pad,) + x.shape[1:])])

    refs = PointCloud(batch(pts[:-1], pts[:1]),
                      batch(mask[:-1], torch.zeros_like(mask[:1])))
    tgts = PointCloud(batch(pts[1:], pts[:1]),
                      batch(mask[1:], torch.zeros_like(mask[:1])))
    t0 = time.perf_counter()
    res = multi_match_sharded(refs, tgts, mesh, bench_lidar.ODOMETRY_ICP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    truth = _pair_truth(q, p)
    err = (res.transform.t[:pairs].double().cpu() - truth.t).norm(dim=-1)
    out.update(mm_err=err.numpy(), mm_wall=wall, mm_pad=pad,
               mm_t=res.transform.t[:pairs].cpu().numpy(),
               mm_converged=res.converged[:pairs].cpu().numpy())
    if mesh.axis("dp").index == 0:
        one = multi_match(PointCloud(pts[:-1].to(dev), mask[:-1].to(dev)),
                          PointCloud(pts[1:].to(dev), mask[1:].to(dev)),
                          bench_lidar.ODOMETRY_ICP)
        out.update(mm_single_t=one.transform.t.cpu().numpy(),
                   mm_single_err=(one.transform.t.double().cpu()
                                  - truth.t).norm(dim=-1).numpy())


RANK_CASES = {"dist_ba": _rank_dist_ba, "dist_ba_f64": _rank_dist_ba_f64,
              "dist_lm_step": _rank_dist_lm_step, "dist_vio": _rank_dist_vio,
              "dist_pose_graph": _rank_dist_pose_graph,
              "multi_match": _rank_multi_match}


def rank_main(argv):
    """One rank of a distributed phase: ``--rank R --world W --backend B
    --store FILE --out DIR --cases a,b``. Joins the group through the file
    store, runs the cases on its card and pickles its readings to
    ``DIR/rank{R}.pkl``."""
    import pickle

    from libwave_tpu_torch.parallel import (
        MeshConfig,
        MultiHostConfig,
        initialize_multihost,
        make_mesh,
    )

    args = dict(zip(argv[0::2], argv[1::2]))
    rank, world = int(args["--rank"]), int(args["--world"])
    check(torch.cuda.is_available(), "no CUDA device for this rank")
    initialize_multihost(MultiHostConfig(
        coordinator_address=f"file://{args['--store']}",
        num_processes=world, process_id=rank), backend=args["--backend"])
    mesh = make_mesh(MeshConfig(dp=world))
    dev = mesh.device
    # the first collective builds the communicator: not inside a solve
    mesh.axis("dp").psum(torch.ones(1, device=dev))
    torch.cuda.synchronize()
    out = {"backend": mesh.backend, "device": str(dev)}
    for case in args["--cases"].split(","):
        t0 = time.perf_counter()
        RANK_CASES[case](mesh, dev, out)
        out[f"{case}_s"] = time.perf_counter() - t0
    with open(Path(args["--out"]) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    torch.distributed.destroy_process_group()


def _run_ranks(world, backend, cases, tmp):
    """Spawn ``world`` ranks of this script; every one must exit 0 within
    DIST_TIMEOUT (else all are killed and the phase fails). Returns their
    readings, in rank order, and the wall seconds."""
    import pickle

    tmp = Path(tmp)
    env = dict(os.environ, PYTHONPATH=str(HERE), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), "--rank", str(r),
         "--world", str(world), "--backend", backend, "--store",
         str(tmp / "store"), "--out", str(tmp), "--cases", ",".join(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        deadline = time.monotonic() + DIST_TIMEOUT
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise SmokeFailure(f"{world} {backend} ranks ({cases}) did not "
                           f"finish in {DIST_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"{world} {backend} ranks: rank {r} exited "
              f"{p.returncode}:\n{log[-4000:]}")
    outs = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs, time.perf_counter() - t0


def _same_on_ranks(what, outs, keys):
    for k in keys:
        for r, o in enumerate(outs[1:], 1):
            check(np.array_equal(o[k], outs[0][k]),
                  f"{what}: rank {r}'s {k} differs from rank 0's")


def _check_dist_ba(outs, world, refs, smi):
    r0 = outs[0]
    cg = _dist_cfg().cg_max_iters
    # the sharded solve's CG vectors are full replicas: every trip through
    # the trip kernel
    want = dict(dense_g_a_window=0, seg_reduce_sorted=(3 + cg) * LM_ITERS,
                seg_broadcast=(2 + cg) * LM_ITERS, hamming_top2=0,
                hamming_distance=0, pcg_trip=cg * LM_ITERS,
                schur_self_blocks=0)
    for r, o in enumerate(outs):
        check(o["ba_counts"] == want, f"dist_ba {world}: rank {r} launched "
              f"{o['ba_counts']}, expected {want}")
        held = {k: v[0] for k, v in o["ba_held"].items()}
        check(held == {"seg_reduce_sorted": 3 + cg,
                       "seg_broadcast": 2 + cg},
              f"dist_ba {world}: rank {r} held {held} calls of one "
              f"iteration to the plain versions")
    _same_on_ranks(f"dist_ba {world}", outs, ("ba_q", "ba_p", "ba_lm",
                                              "ba_costs"))
    costs = r0["ba_costs"].astype(np.float64)
    check(np.isfinite(costs).all() and costs[-1] < r0["ba_initial"],
          f"dist_ba {world}: costs {r0['ba_initial']} -> {costs}")
    # f32: splitting a landmark's sum over ranks rounds it otherwise, and 20
    # CG steps amplify that as they amplify any summation order (the
    # single-device solve on the card and on the CPU part by as much). So
    # the sharded first iteration is held to the single-device one within
    # DIST_F32_FLOOR_FACTOR times that floor, and at f64 to rtol 1e-7, the
    # JAX package's own bound for a distributed against a local LM
    # iteration at f64 (tests/test_parallel.py:80)
    rel = abs(costs[0] - refs["f32"]) / abs(refs["f32"])
    limit = DIST_F32_FLOOR_FACTOR * refs["floor"]
    check(rel <= limit, f"dist_ba {world}: first iteration at f32 "
          f"{costs[0]!r} vs the single-device solve's {refs['f32']!r}: "
          f"{rel:.3e} apart, limit {limit:.3e} ({DIST_F32_FLOOR_FACTOR}x "
          f"that solve's card-vs-CPU gap {refs['floor']:.3e})")
    rel64 = abs(r0["ba64_first"] - refs["f64"]) / abs(refs["f64"])
    check(rel64 <= 1e-7, f"dist_ba {world}: first iteration at f64 "
          f"{r0['ba64_first']!r} vs the single-device solve's "
          f"{refs['f64']!r} (rtol 1e-7)")
    syncs = r0["ba_syncs"]
    if r0["backend"] == "nccl":
        check(not syncs, f"dist_ba {world} (NCCL): synchronizing calls "
              f"inside solve_ba_sharded: {syncs}")
    share = r0["ba_collective_s"] / r0["ba_timed_wall"]
    print(f"dist_ba: {world} rank(s), {r0['backend']} on one card: "
          f"headline problem (200 poses, 10,000 landmarks, f32, matrix-free, "
          f"{LM_ITERS} LM, {cg} CG) in {world} pose blocks; per rank per LM "
          f"iteration {3 + cg} reduce and {2 + cg} broadcast launches (the "
          f"plain matvec of sharded blocks), one iteration's calls "
          f"held to the plain versions bit for bit; the ranks' states equal "
          f"bit for bit; cost {r0['ba_initial']:.6e} -> {costs[-1]:.6e}, "
          f"first iteration {rel:.3e} from the single-device solve's (limit "
          f"{limit:.3e}: {DIST_F32_FLOOR_FACTOR}x that solve's gap between "
          f"the card and the CPU, {refs['floor']:.3e}); at "
          f"f64 {rel64:.3e} (rtol 1e-7); {r0['ba_rate']:.4f} LM iterations/s "
          f"per rank; "
          f"{r0['ba_collectives'] // LM_ITERS} collectives an iteration "
          f"take {share:.4f} of it (host clock, card synchronized around "
          f"each); synchronizing calls: "
          + ("none (sync debug mode)" if r0["backend"] == "nccl" else
             "not checked (gloo stages each collective through the host, "
             "which synchronizes)") + f" | {smi}")
    return r0["ba_rate"]


def _check_group2(outs, smi):
    r0 = outs[0]
    card, cpu = r0["f64_card"], r0["f64_cpu"]
    # the costs fall ~3,000-fold to a minimum where the last bits of the
    # states decide them: each is held to rtol DIST_F64_RTOL beside an atol
    # of DIST_F64_ATOL of the first iteration's cost; the states to 1e-9 m
    diff = np.abs(card[0] - cpu[0])
    limits = DIST_F64_RTOL * np.abs(cpu[0]) + DIST_F64_ATOL * abs(cpu[0][0])
    crel = float(np.max(diff / np.abs(cpu[0])))
    cabs = float(np.max(diff)) / abs(cpu[0][0])
    pgap = float(np.max(np.abs(card[1] - cpu[1])))
    lgap = float(np.max(np.abs(card[2] - cpu[2])))
    check(bool(np.all(diff <= limits)) and pgap <= 1e-9 and lgap <= 1e-9,
          f"dist_ba f64: card vs CPU costs {diff.tolist()} against "
          f"{limits.tolist()} (rtol {DIST_F64_RTOL}, atol {DIST_F64_ATOL} "
          f"of the first cost), poses {pgap:.3e} m, landmarks {lgap:.3e} m "
          f"(limit 1e-9)")
    print(f"dist_ba f64: 2 gloo ranks, {DIST_F64_PROBLEM} f64, CG to "
          f"convergence: the card's sharded solve against the same on the "
          f"CPU: costs at most {crel:.3e} of themselves and {cabs:.3e} of "
          f"the first iteration's (rtol {DIST_F64_RTOL} + atol "
          f"{DIST_F64_ATOL} of the first cost), poses {pgap:.3e} m, "
          f"landmarks {lgap:.3e} m (limit 1e-9): "
          f"{' '.join(f'{c:.12e}' for c in card[0])}")

    _same_on_ranks("dist_vio", outs, ("vio_costs", "vio_p"))
    cfg = bench_problem.vio_config("pcg")
    it, cg = cfg.max_iterations, cfg.cg_max_iters
    want = dict(dense_g_a_window=0, seg_reduce_sorted=(3 + cg) * it,
                seg_broadcast=(2 + cg) * it, hamming_top2=0,
                hamming_distance=0, pcg_trip=cg * it, schur_self_blocks=0)
    for r, o in enumerate(outs):
        check(o["vio_counts"] == want, f"dist_vio: rank {r} launched "
              f"{o['vio_counts']}, expected {want}")
    costs, single = r0["vio_costs"], r0["vio_single"]
    rel = abs(costs[0] - single[0]) / abs(single[0])
    check(rel <= 1e-3 and np.isfinite(costs).all()
          and costs[-1] < r0["vio_initial"],
          f"dist_vio: costs {r0['vio_initial']} -> {costs}; single-device "
          f"first iteration {single[0]}")
    print(f"dist_vio: 2 gloo ranks, bench_vio's problem ({r0['vio_N']} "
          f"keyframes, f32, PCG, {it} LM, {cg} CG) in 2 keyframe blocks, "
          f"{3 + cg} reduce and {2 + cg} broadcast launches per rank per LM "
          f"iteration: cost "
          f"{r0['vio_initial']:.6e} -> {costs[-1]:.6e}, first iteration "
          f"{rel:.3e} from the single-device PCG solve (rtol 1e-3); ATE "
          f"{r0['vio_ate0']:.6f} -> {r0['vio_ate']:.6f} m; "
          f"{r0['vio_rate']:.3f} keyframes/s per rank; ranks equal bit for "
          f"bit | {smi}")

    err, single_err = r0["mm_err"], r0["mm_single_err"]
    bound = 1.5 * float(single_err.max()) + 1e-3
    check(bool(r0["mm_converged"].all()) and float(err.max()) <= bound,
          f"multi_match: worst pair error {err.max()} m, bound {bound} "
          f"(one rank's {single_err.max()})")
    _same_on_ranks("multi_match", outs, ("mm_t",))
    same = np.array_equal(r0["mm_t"], r0["mm_single_t"])
    pairs = len(err)
    print(f"multi_match: 2 gloo ranks, the lidar phase's {pairs} pairs of "
          f"4,096 points (f32, full-resolution ICP; {r0['mm_pad']} masked "
          f"pair to an even batch), {pairs // 2 + r0['mm_pad']} a rank: worst "
          f"translation error {err.max():.6e} m against one rank's "
          f"{single_err.max():.6e} (bound 1.5x + 1 mm), all converged; the "
          f"bits {'equal' if same else 'differ from'} one rank's (gap "
          f"{np.abs(r0['mm_t'] - r0['mm_single_t']).max():.3e} m); "
          f"{pairs / r0['mm_wall']:.3f} pairs/s | {smi}")


def _check_lm_step(outs, world, smi):
    """The one-step on each (dp, tp) mesh: the cost within rtol 1e-7 of a
    local LM iteration's, the poses and the gathered map near its (1e-6 m,
    a sanity bound: the two sum in other orders), the poses and cost the
    same bits on every rank and a chunk the same on its dp replicas, each
    rank holding ceil(M / tp) landmark rows, the reduce and broadcast
    launches per rank those of the flat bank, one step's calls held to the
    plain versions bit for bit."""
    local = outs[0]["step_local"]
    M = local["lm"].shape[0]
    flat = f"{world}x1"
    for dp, tp in DIST_LM_MESHES[world]:
        tag = f"{dp}x{tp}"
        runs = [o[f"step_{tag}"] for o in outs]
        r0 = runs[0]
        what = f"dist_lm_step {tag}"
        mt = -(-M // tp)
        for r, run in enumerate(runs):
            check(run["index"] == (r // tp, r % tp),
                  f"{what}: rank {r} is at {run['index']}")
            check(run["chunk"].shape == (mt, 3),
                  f"{what}: rank {r} holds {run['chunk'].shape} landmark "
                  f"rows, not ({mt}, 3)")
            for k in ("cost", "q", "p", "lm"):
                check(np.array_equal(run[k], r0[k]),
                      f"{what}: rank {r}'s {k} differs from rank 0's")
            check(np.array_equal(run["chunk"], runs[r % tp]["chunk"]),
                  f"{what}: rank {r}'s chunk differs from its dp replica's")
            want = outs[r][f"step_{flat}"]["counts"]
            check(run["counts"] == want, f"{what}: rank {r} launched "
                  f"{run['counts']}, the flat bank {want}")
            held = {k: run["counts"][k] for k in run["held"]}
            check(run["held"] == held
                  and set(held) == {"seg_reduce_sorted", "seg_broadcast"},
                  f"{what}: rank {r} held {run['held']} calls of a step "
                  f"that launched {run['counts']}")
        check(np.array_equal(np.concatenate(
            [runs[t]["chunk"] for t in range(tp)])[:M], r0["lm"]),
              f"{what}: gather_landmarks is not the chunks in order")
        rel = abs(r0["cost"] - local["cost"]) / abs(local["cost"])
        gap = max(float(np.abs(r0[k] - local[k]).max())
                  for k in ("q", "p", "lm"))
        check(rel <= 1e-7 and gap <= 1e-6,
              f"{what}: cost {r0['cost']!r} vs a local LM iteration's "
              f"{local['cost']!r} (rel {rel:.3e}, rtol 1e-7); states "
              f"{gap:.3e} apart (limit 1e-6)")
        c = r0["counts"]
        mem = ", ".join(f"rank {r} {run['lm_bytes']:,} B landmark-side, "
                        f"peak {run['peak'] / 2**20:.1f} MiB"
                        for r, run in enumerate(runs))
        print(f"dist_lm_step: {world} gloo ranks, ({dp}, {tp}) mesh, the "
              f"headline problem at f64 (10,000 landmarks, {mt:,} rows a "
              f"rank, {r0['bank']:,} observation slots a rank): cost "
              f"{r0['cost']:.12e}, a local LM iteration {local['cost']:.12e} "
              f"(rel {rel:.3e}, rtol 1e-7), states {gap:.3e} apart; "
              f"{c['seg_reduce_sorted']} reduce and {c['seg_broadcast']} "
              f"broadcast launches per rank (the flat bank's), held to the "
              f"plain "
              f"versions bit for bit; ranks equal bit for bit, dp replicas "
              f"of a chunk too; {mem} | {smi}")


def _check_pose_graph(outs, world, smi):
    r0 = outs[0]
    _same_on_ranks(f"dist_pose_graph {world}", outs, ("pg_trace", "pg_p"))
    trace, single = r0["pg_trace"], r0["pg_single"]
    rel = abs(trace[-1] - single[-1]) / abs(single[-1])
    check(rel <= 1e-6 and r0["pg_back"] and trace[-1] < trace[0],
          f"dist_pose_graph {world}: final cost {trace[-1]} vs single-device "
          f"{single[-1]} (rtol 1e-6); unpartition gives the poses back: "
          f"{r0['pg_back']}")
    gap = float(np.abs(r0["pg_p"] - r0["pg_single_p"]).max())
    print(f"dist_pose_graph: {world} gloo ranks, the circle of "
          f"{DIST_PG_POSES} poses (f64; closures onto the previous block, "
          f"{r0['pg_seps']} separators, the wrap, both directions; "
          f"{DIST_PG_CFG.max_iterations} GN, {DIST_PG_CFG.cg_max_iters} CG): "
          f"final cost {trace[-1]:.9e} against the single-device "
          f"solve's {single[-1]:.9e} (rel {rel:.3e}, rtol 1e-6), positions "
          f"{gap:.3e} m apart; unpartition gives the poses back; "
          f"{r0['pg_wall']:.3f} s a solve | {smi}")


def phase_distributed(dev, smi):
    """The distributed phases: dist_ba at 1 (NCCL), 2 and 4 ranks (gloo);
    at 2 ranks also dist_ba f64, dist_lm_step, dist_vio, dist_pose_graph
    and multi_match; at 4 dist_lm_step and dist_pose_graph. The f32
    yardstick is the single-device matrix-free headline solve on the card
    through the plain matvec, the sharded solves' own (the fused one sums
    in another order)."""
    problem, state = bench_problem.make_problem(device=dev)
    with mock.patch.object(schur, "_takes_fused_matvec", return_value=False):
        _, single = ba.solve_ba(problem, state, _dist_cfg())
    f32 = float(single["costs"][0])
    cpu_dev = torch.device("cpu")
    _, cpu = ba.solve_ba(to_device(problem, cpu_dev),
                         to_device(state, cpu_dev),
                         _dist_cfg())
    refs = {"f32": f32,
            "floor": abs(float(cpu["costs"][0]) - f32) / f32,
            "f64": _first_iteration_f64(problem, state, ba.solve_ba)}
    del problem, state
    torch.cuda.empty_cache()
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world, backend, cases in DIST_GROUPS:
            sub = Path(tmp) / f"r{world}"
            sub.mkdir()
            outs, wall = _run_ranks(world, backend, cases, sub)
            check(all(o["backend"] == backend for o in outs),
                  f"{world} ranks ran {[o['backend'] for o in outs]}")
            times = ", ".join(f"{c} {outs[0][f'{c}_s']:.1f} s" for c in cases)
            print(f"distributed: {world} rank(s) over {backend} on "
                  f"{outs[0]['device']} in {wall:.1f} s ({times})")
            rates[world] = _check_dist_ba(outs, world, refs, smi)
            if world == 2:
                _check_group2(outs, smi)
            if "dist_lm_step" in cases:
                _check_lm_step(outs, world, smi)
            if "dist_pose_graph" in cases:
                _check_pose_graph(outs, world, smi)
    print("dist_ba: LM iterations/s per rank, ranks sharing one card: "
          + ", ".join(f"{w} rank(s) {r:.4f}" for w, r in rates.items())
          + f" (one card: no figure of scaling across cards) | {smi}")


def phase_pp_overlap(dev, smi):
    """bench.py's 8 pp windows (FAST + BRISK + top-2 match; RANSAC +
    essential + pose), serial on one stream against two streams."""
    from libwave_tpu_torch.bench_parallel import pp_frames, pp_stages
    from libwave_tpu_torch.pipelines.overlap import pipelined_windows, \
        serial_windows

    frames = pp_frames(8, device=dev)
    fe, be = pp_stages()
    be(fe(frames[0]))  # warm-up
    torch.cuda.synchronize()
    fs, bs = torch.cuda.Stream(), torch.cuda.Stream()
    runs, walls = {}, {"serial": [], "streams": []}
    for which in ("serial", "streams", "streams", "serial"):
        hamming.hamming_top2.launches = 0
        t0 = time.perf_counter()
        if which == "serial":
            out = serial_windows(fe, be, frames)
        else:
            out = pipelined_windows(fe, be, frames, frontend_stream=fs,
                                    backend_stream=bs)
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
        check(hamming.hamming_top2.launches == len(frames),
              f"pp_overlap {which}: {hamming.hamming_top2.launches} top-2 "
              f"launches for {len(frames)} windows")
        runs.setdefault(which, out)
        check(all(torch.equal(a, b) for a, b in zip(out, runs[which])),
              f"pp_overlap {which}: two runs differ")
    check(all(torch.equal(a, b) for a, b in zip(runs["serial"],
                                                  runs["streams"])),
          "pp_overlap: the two-stream results differ from the serial ones")
    s, p = (float(np.median(walls[k])) / len(frames)
            for k in ("serial", "streams"))
    print(f"pp_overlap: {len(frames)} windows of 480x640 (FAST-512 + BRISK + "
          f"top-2 match, one top-2 launch a window; RANSAC 2,048 hypotheses "
          f"+ essential + pose): {s:.4f} s/window serial, {p:.4f} s/window "
          f"on two streams (ratio {s / p:.3f}); results equal bit for bit | "
          f"{smi}")


def phase_utils(smi):
    """Runs :func:`utils_main` in a child process of this script
    (``--utils``): ``torch.profiler`` leaves its hooks in the process that
    used it, which slows that process's later launches: with this phase
    first in this process the matrix-free headline solve ran 14.2-14.4 LM
    iterations/s against 17.8-21.7 without it (NVIDIA H100 80GB HBM3,
    700 W)."""
    proc = subprocess.run(
        [sys.executable, str(HERE / "chip_smoke.py"), "--utils", smi],
        env=dict(os.environ, PYTHONPATH=str(HERE)), capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0, f"utils: the child exited {proc.returncode}"
          f":\n{(proc.stdout + proc.stderr)[-4000:]}")
    print(proc.stdout.strip())


def utils_main(smi):
    """utils.timing.Timer against CUDA events around the segment reduce,
    and utils.trace.profile_trace naming it (the kernels are built: the
    parent's build phase left them in ``_build/``)."""
    from libwave_tpu_torch.utils.timing import Timer
    from libwave_tpu_torch.utils.trace import profile_trace, span

    check(torch.cuda.is_available(), "utils: no CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    K, M = 480_000, 10_000
    vals = torch.randn((6, K), generator=g, device=dev)
    ell = segmm.sorted_layout(torch.randint(0, M, (K,), generator=g,
                                            device=dev), M)
    calls = 200
    for _ in range(3):
        segmm.seg_reduce_sorted(vals, *ell)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with Timer() as t:
        start.record()
        for _ in range(calls):
            out = segmm.seg_reduce_sorted(vals, *ell)
        end.record()
        t.block_on(out)
    ev_ms = start.elapsed_time(end)
    t_ms = t.elapsed * 1e3
    check(abs(t_ms - ev_ms) <= 0.05 * ev_ms + 0.05,
          f"utils: Timer {t_ms:.4f} ms vs CUDA events {ev_ms:.4f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp) as prof:
            with span("seg_reduce_calls"):
                for _ in range(5):
                    segmm.seg_reduce_sorted(vals, *ell)
            torch.cuda.synchronize()
        text = (Path(tmp) / "trace.json").read_text()
    names = {e.key for e in prof.key_averages()}
    check("seg_reduce_sorted_kernel" in text,
          "utils: the profiler trace does not name the segment reduce kernel")
    check("seg_reduce_calls" in names,
          "utils: the profiler does not list the span")
    print(f"utils: Timer {t_ms:.4f} ms vs CUDA events {ev_ms:.4f} ms over "
          f"{calls} segment reduces (6 x 480,000 -> 10,000; limit 5% + 0.05 "
          f"ms); profile_trace's trace.json names seg_reduce_sorted_kernel "
          f"and the span | {smi}")


def _kernel_entry(name, source, replaces, n_launches, stats):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": n_launches}
    entry.update({k: stats[k] for k in keys})
    return entry


def main():
    t_start = time.perf_counter()
    name, smi, popc_rate = phase_device()
    phase_build()
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    problem, state = bench_problem.make_problem(device=dev)
    print(f"problem: headline problem (200 poses, 10,000 landmarks, 300 "
          f"observations per pose, {len(problem.bands.entries)} band "
          f"entries) built in {time.perf_counter() - t0:.3f} s")
    cfg = bench_problem.bench_config(LM_ITERS)
    g_a = phase_kernel(problem, state, cfg)
    ga_launches = phase_headline(problem, state, cfg, smi)
    phase_small_reference(dev)
    seg = phase_seg(problem, dev, smi)
    mf_counts, mv_stats = phase_matrix_free(problem, state, smi)
    del problem, state
    t0 = time.perf_counter()
    phase_ba_dataset(dev, smi)
    phase_ba_batched(dev, smi)
    phase_ba_large(dev, smi)
    print(f"chip_smoke: ba_dataset, ba_batched and ba_large took "
          f"{time.perf_counter() - t0:.1f} s")
    phase_vio(dev, smi)
    phase_euroc(dev, smi)
    phase_windowed(dev, smi)
    phase_mh01_scale(dev, smi)
    phase_windowed_ba(dev, smi)
    phase_icp(dev, smi)
    phase_lidar_odometry(dev, smi)
    phase_ground(dev, smi)
    t0 = time.perf_counter()
    frames = bench_frontend.make_euroc_frames()
    check(frames.shape == (SEQUENCE_FRAMES, 480, 752),
          f"EuRoC frames have shape {frames.shape}")
    print(f"frames: {SEQUENCE_FRAMES} EuRoC cam0 frames (752x480, 400 "
          f"landmarks, seed 0) rendered in {time.perf_counter() - t0:.3f} s")
    ham = phase_hamming(frames, dev, smi, popc_rate)
    table_launches = phase_pair(dev, smi)
    top2_launches = phase_sequence(frames, dev, smi)
    phase_pixels(dev, smi)
    phase_orb(frames, dev, smi, popc_rate)
    phase_lsh(dev, smi)
    phase_vo_pair(dev, smi)
    phase_batched(frames, dev, smi)
    t0 = time.perf_counter()
    phase_gps_trajectory(dev, smi)
    phase_nlls(dev, smi)
    phase_float_flann(dev, smi)
    phase_leaves(dev, smi)
    print(f"chip_smoke: gps_trajectory, nlls, float_flann and leaves took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    phase_distributed(dev, smi)
    phase_pp_overlap(dev, smi)
    phase_utils(smi)
    print(f"chip_smoke: the distributed phases, pp_overlap and utils took "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        _kernel_entry("segmm_g_a", KERNEL_SOURCE, KERNEL_REPLACES,
                      ga_launches, g_a),
        _kernel_entry("seg_reduce", SEG_SOURCE, REDUCE_REPLACES,
                      mf_counts["seg_reduce_sorted"], seg["seg_reduce"]),
        _kernel_entry("seg_broadcast", SEG_SOURCE, BROADCAST_REPLACES,
                      mf_counts["seg_broadcast"], seg["seg_broadcast"]),
        _kernel_entry("hamming_top2", HAMMING_SOURCE, TOP2_REPLACES,
                      top2_launches, ham["top2"]),
        _kernel_entry("hamming_table", HAMMING_SOURCE, TABLE_REPLACES,
                      table_launches, ham["table"]),
        *(_kernel_entry(k, MATVEC_SOURCE, MATVEC_REPLACES, mf_counts[k], v)
          for k, v in mv_stats.items() if _is_matvec(k)),
        _kernel_entry("pcg_trip", PCG_SOURCE, PCG_REPLACES,
                      mf_counts["pcg_trip"], mv_stats["pcg_trip"]),
        _kernel_entry("schur_self_blocks", PRECOND_SOURCE, PRECOND_REPLACES,
                      mf_counts["schur_self_blocks"],
                      mv_stats["schur_self_blocks"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))

if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--rank"]:
            rank_main(sys.argv[1:])
        elif sys.argv[1:2] == ["--utils"]:
            utils_main(sys.argv[2])
        else:
            main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
