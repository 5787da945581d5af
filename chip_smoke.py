#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xframe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-shapes production

Phases, each printing JSON lines with its seconds:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions,
              whether h5py and matplotlib are installed (importlib's
              find_spec); TF32 off for matmuls and cuDNN (the
              Newton-Schulz polar is pinned at float32).
  2. build    nvcc build of xframe_tpu_torch/csrc/*.cu, one nvcc per source,
              all in parallel.
  3. kernels  each of the twelve kernels against its plain PyTorch version,
              median times of kernel and plain version from CUDA events, and
              the bound: the larger of the FLOP the function needs over
              67 TFLOP/s (FP32, no tensor cores) and the bytes it must move
              (each input and Legendre table read once, each output written
              once) over 3.35 TB/s, from the shapes of this run's inputs
              (elementwise epilogues not counted). The FLOP count each
              phi-transform as an FFT, each Legendre stage over the (l, m)
              triangle and each Hermitian product of the Newton-Schulz
              steps once (kernel_work, ns_work). The SHT and fused-
              iteration kernels (B1-B6, B9-B12) run at tutorial shapes
              (2 restarts x 128 shells, L = 64, 256x512 grid): max|kernel -
              plain| / max|plain| <= 1e-4 for every output (float32 sums
              taken in another order over 512 phi and 256 theta terms; the
              fused update is compared away from the real constraint's
              thresholds, where a rounding difference flips a point (and
              its gated case is held bitwise against the ungated kernel
              with and without ft-stab), and
              the projections without the psi_p analysis (B11) away from
              I_new = 0, where the square root of a rounding difference
              weighs up to 1e-3; the counts left out are printed). The projections
              (B4, B11) take random coefficients, so that I_new < 0 on about
              half the grid. The fused update runs (HIO,
              ft-stab), (ER, ft-stab) and (RAAR, no ft-stab) with
              threshold_low and limit_imag set, then (HIO, ft-stab) on the
              (n_q, n_theta, n_phi) weight grid and with the gate (0, 1)
              across two restarts (at production one restart's 256 rows
              split into two of 128), also on the dense route. The polar kernel (B7) and the
              fused projection (B8) run every bucket of one projection, at
              tutorial (2 restarts, N_q = 128, L = 64: c = 127, 129) and
              production shapes (1 restart, N_q = 256, L = 127: c = 127,
              253, 255), with the minimax schedule, on well-conditioned
              inputs (B7: Q1·diag(s)·Q2† with s in [0.2, 1]; B8: orthonormal
              V, D² in [0.5, 1], I = V·Q1·diag(s)·Q2†); their times are those
              of the whole projection (one call per bucket), and the kernels
              line gives the production ones, the shapes of their path.
              B7 and B8 are also timed bucket by bucket, at the cluster
              shape the wrapper chooses (S blocks of G product groups,
              "SxG") and at every other shape the card holds of that
              kernel (cudaOccupancyMaxActiveClusters, printed). B1-B6
              and B9-B12 run their FFT route at the phase's shapes (the
              phase fails on any other route there) and their dense route
              on a grid whose n_phi has a prime factor other than 2, 3 and
              5 (65x130 at L = 64, 133x266 at L = 127; B5 there in the
              HIO, ft-stab case; B11 compared away from I_new = 0 as
              above), each line naming its route.
              Bounds NS_TOL: 2e-3 absolute on the unitary W for B7, 5e-3
              relative to max|plain| for B8's output (the JAX package's
              bound for its K5 against its jnp path,
              tests/test_phasing.py:389). Both sit on the float32 floor of
              the minimax iteration, whose steps amplify rounding (a = 8.3
              in the first): on the card the plain float32 version departs
              from its float64 run by up to 7.6e-4 (B7) and 4.1e-3 (B8),
              and the kernel, summing in another order, as far (0.8e-3,
              3.0e-3), so two float32 runs may differ by their sum. Both
              distances to the float64 run are printed. B1, B2 and B3 also
              at the simulate_ccd tutorial's shapes (512 rows, L = 128,
              256x512: n_m = 257), B2 and B9 at those of extract's
              SHT-constraint options (512 rows, L = 69, 128x256), 1e-4 of
              max, timed, lines with shapes "simulate" and "extract".
              Then the bf16-table forms (fourier_transform.
              fused_bf16_tables, names ending in _bf16) of B1-B6 and
              B9-B12, on the FFT route at the phase's shapes and on the
              dense route at phase_dense's grid: each against its plain
              version on the card (the plain SHT at mxu_dtype bf16, the
              same bf16-rounded Legendre operands and float32 sums),
              largest error within BF16_TOL of max and root mean square
              error within BF16_RMS_TOL (5e-5) of max, more than 1e-5 of
              max from its float32 form on the same inputs; timed; bound
              the larger of the tensor-core FLOP over 989 TFLOP/s (the FFT
              route's Legendre GEMMs but B4's), the CUDA-core FLOP over 67
              TFLOP/s and the bytes (tables at two bytes a value) over
              3.35 TB/s (bf16_work, bf16_bound).
  4. small    at N_q=16, L=8 on the card against the same runs on the CPU
              through the plain versions, from the same densities (error
              series within 1e-4 on the first iteration, 0.05 overall): the
              fused and the stepwise slice, and the fused variants
              k2_fwd=False (B11), k1_abs2=True (B12) and both; at N_q=16,
              L=64 on
              the smallest grid (65x130) the fused slice under
              newton_schulz_pallas (B8), on HIO 2 + SW + ER 1.
  5. slice    MTIP phasing at tutorial scale: make_demo_problem(128, 64,
              256x512, Newton-Schulz with the minimax schedule, kernels on),
              2 restarts through MTIP.run_batch on the tutorial schedule
              5x(60 HIO + SW + 40 ER) + SW + 100 ER with ft-stab through the
              fused iteration (the default), then HIO 60 + SW + ER 40
              through the stepwise one (fused_pipeline=False) from the same
              densities.
  6. variants the tutorial problem through the fused variants k2_fwd=False
              (B11, then B1 on psi_p) and k1_abs2=True (B12), HIO 60 + SW +
              ER 40 each from the same densities; their first-iteration
              errors must agree with the default fused path's within 1e-4.
  7. replay   the tutorial schedule again, best_mode="replay", through
              MultiStartRunner from the fused slice's initial densities:
              error series and best_err within REPLAY_TOL (2e-5) relative of
              the eager fused slice's, best_rho within REPLAY_TOL of its
              max, best_mask equal (the JAX package's bounds for replay
              against eager; the same kernels on the same inputs, so 0 is
              expected); s/iteration/restart of both and each restart's
              anchor_len; the implied launch counts include the replayed
              iterations, counted from the anchors read before each
              materialisation.
  8. checkpoint  CheckpointingRunner over HIO 60 + SW + ER 40, eager and
              replay: one chunk with a checkpoint in a temporary directory,
              then a fresh runner resumes; errors, best_err and best_rho
              equal an uninterrupted run bitwise; the checkpoint's bytes,
              one save's and one load's seconds.
  9. fidelity make_demo_problem(32, 16) on the card with the schedule and
              initial density of tests/test_torch_fidelity.py:
              align_to_ground_truth against the demo's truth > 0.9 (the JAX
              package's bound, tests/test_phasing.py:125); the replay
              phase's restarts, ranked by rank_restarts, each aligned to the
              truth on the card (correlation, angles, inversion, the
              aligner's B1 and B2 launches), the best also on the CPU
              through the plain transforms: both correlations within 1e-3.
 10. worker the reconstruct worker through select_worker + run on its
              tutorial settings (replay; 4 restarts in chunks of 2 from seed
              0; the 600-iteration schedule, its refinement SW_center + ER
              100 as in tests/test_pipeline_integration.py, so that the
              centering runs B1 and B2 on the worker's path) from an
              invariants archive of the tutorial problem in a temporary
              XFRAME_TPU_HOME, its grid
              put on the problem's (N_q, L, q_max, 256x512, the support
              radius as particle_radius): set-up, phasing, chunk, collect
              and save seconds, the archive's bytes, peak device memory;
              chunk 0 equal bitwise to a MultiStartRunner run of the
              worker's MTIP and schedule from initial_density_batch(0, 2)
              (errors, best_err, best_rho), and equal bitwise to the
              eager twin of that MTIP (errors, best_err, best_rho, rho,
              support: replay through SW_center); SW_center on the card
              against the worker's CPU set-up (plain transforms) on chunk 0
              after its first HIO + SW + ER: each centered density within
              1e-4 of its max, the supports equal where the blurred density
              is not within 1e-4 of the threshold; each chunk's launch counts
              equal the schedule's implied ones (replayed iterations
              included) and the collection's its finalize and deg-2
              diagnostic; every restart's final error below half the mean
              of its first five; the best restart's ground-truth
              correlation above 0.75 (the JAX gate,
              tests/test_pipeline_integration.py:217), all four printed
              (the tutorial's 8 are run by phase 12). Phases 10, 11 and
              options write no .vts (NO_VTK), so that their save seconds
              stay comparable with earlier runs'; phases 12 and 14 write
              them.
 11. average  the average worker through select_worker + run on its
              tutorial settings with PRTF, FSC and FQCB over the worker's
              archive: the averaged density's ground-truth correlation
              above 0.85 (tests/test_pipeline_integration.py:211); the
              aligned count, the PRTF resolution, the FSC and FQCB curves,
              load, align, metrics and save seconds, B1 and B2 launches per
              candidate. Then phase `archives` (under 10 s; its line names
              the branch that ran): the worker's archive re-read through
              the format-agnostic ProjectStore.load and saved again with
              four figures asked. Without h5py and matplotlib (the GPU
              machine as probed): the save writes .npz with a line naming
              h5py and a notice naming matplotlib, `view` exits naming
              matplotlib, and input.source experiment stops naming h5py
              before any device work. Where they import: the .h5 reads
              back equal to the same tree through .npz, the PNGs exist,
              `view` draws, and a synthetic SPB run folder (4 modules, 20
              frames, as tests/test_spb.py) runs through PanelCorrelator on
              the card, within 1e-4 of max of the CPU, every frame good.
              The temporary home is deleted after.
 12. chain    the tutorial chain as a user runs it, in a temporary
              XFRAME_TPU_HOME, through select_worker + run on the shipped
              tutorial settings of each worker and nothing else:
              simulate_ccd (6 spheres, N = 512, L = 128, 512x256x512: the
              density on the card, B1, the Hankel matmul, B2, B3, the B_l
              GEMM, the C_n sums and the irfft) -> extract (L = 69) ->
              reconstruct (N = 128, L = 64; cut in depth to 4 restarts in
              one batch from seed 0, phase mesh's one-card reference) ->
              average. One
              line per stage: seconds and sub-stages, archive bytes, peak
              device memory, kernel launches (every FusedSHT and
              FusedIteration built in the stage counted). Checks: B1, B2
              and B3 one launch each on the simulate stage; the CC finite
              and exactly q1<->q2 symmetric; the card's density against
              build_density_from_shapes on a stride-8 sub-grid (disagreement share
              below 5e-3, tests/test_library.py:200-203); the kernels'
              intensity coefficients within 1e-4 of max of the plain
              versions on the card on the same density; extract's B_l
              finite, odd orders zero, each even order PSD (least
              eigenvalue >= -1e-6 of the largest), its relative difference
              to the simulated B_l printed; every restart finite; the
              averaged density's ground-truth correlation >= 0.75 (the JAX
              chain reached 0.80, docs/performance.md:779), every
              restart's printed. Then the chain at
              tests/test_pipeline_integration.py's sizes and overrides
              (N = 48, L = 14 -> N = 24, L = 10) on the card, extract also
              on the CPU from the card's CC: V_l V_l^dag within 1e-8 of
              max of the card's; average > 0.85, best > 0.75. Between the
              two, line extract_options: extract on the tutorial
              simulate_ccd archive with prephasing (1 x 10 SHT round
              trips, B2 then B9 each), the optimized low-resolution
              coefficients (max_order 8, 10 round trips) and the estimate
              (one B2), on the card and on the CPU: launch counts equal
              the round trips run (+1 B2), V_l V_l^dag and the
              low-resolution ones within 1e-8 of max, the convergence
              flags and iteration counts equal, n_particles within one
              scale step (printed, with the negative shares). Then phase
              options on the chain's invariants archive: the reconstruct
              worker on its tutorial settings at full width (N = 128,
              L = 64, 256x512), 2 restarts, one cycle (HIO 60 + SW + ER
              40), twice: (i) fused, the auto-correlation initial support
              (B5 on its weight grid) and linked ft-stab of delay 2 on
              HIO and ER (B5's gate) under replay; (ii) stepwise, the
              error metrics (reciprocal l2 and deg2, main = max), the
              particle-number estimate (ER, projected), the bucketed
              fixed-volume shrink-wrap and ns_sigma_min 1e-5. Lines
              options, options_launches, options_checks: seconds,
              s/iteration/restart, peak memory; launches equal the implied
              ones; against the CPU worker's set-up on the same settings:
              the first iteration's error columns within 1e-4, (i) the
              initial support away from its threshold (points within 1e-5
              of max A left out, counted), replay against eager (2e-5),
              the enforce history and each linked segment's gates against
              the CPU's bookkeeping on the card's errors, (ii) the first
              ER iteration's n_hat equal to the CPU's or next to it in the
              scan (its other columns where equal), each bucketed
              support's volume within one point's weight above its
              target, the schedule equal to the host copy's. The CPU
              worker's MTIP is rebuilt on the card's initial support
              (cpu_twin), so that both sum with the same weight grid; (i)
              also prints both float32 runs' distance to the same first
              iteration in float64 on the card; (ii) prints the
              particle-number estimate's scan objective at the card's and
              the CPU's candidate, in float32 and in float64 on both
              devices (line field particle_number_scan). Then phase bf16
              on the same invariants (lines bf16, bf16_checks): options'
              settings without their options (the fused defaults under
              replay; 2 restarts, HIO 60 + SW + ER 40) with
              fourier_transform.fused_bf16_tables, beside the same run
              without it: launches as implied in the bf16 forms'
              counters (B1-B6, B9, B10 with finalize), no float32 form
              launched, every restart finite and below half the mean of
              its first five, the first iteration within 1e-4 of the CPU
              worker's with the key (its plain bf16 path); the variants
              k2_fwd=False (B11) and k1_abs2=True (B12) of its MTIP, 20
              HIO iterations from its densities, launches as implied, the
              first iteration within 1e-4 of the run's; printed: the
              distance from the float32 run (errors, best densities) and
              both runs' correlations to the truth. Then phase
              precision on the same invariants (lines precision): (i) the
              worker there in float64 and (ii) under fused_sht false,
              each 2 restarts, one cycle: no kernel launched, the plain
              transforms and the stepwise iteration, final error below
              half the mean of the first five; (i) the first iteration
              within 1e-9 of the CPU's float64 run, the default float32
              kernel path's distance from it printed, (ii) within 1e-4 of
              the stepwise kernel path from the same densities; seconds,
              s/iteration/restart, peak memory; (vi) run (i)'s settings
              with mesh {restarts: 1, theta: 2} (the θ axis of the plain
              transforms split over two ranks sharing cuda:0, every
              analysis and reduction over the grid summed over them),
              held to run (i)'s own run, no second reference: ρ0
              bitwise, the first iteration within 1e-10 relative, the
              iterations after the shrink-wrap within 1e-6 where both
              final supports agree (else not compared: HIO's chaos
              parts the two series in between; their distance printed
              every 10 iterations), at every 5th iteration and at 59
              and 99 one iteration of (i)'s MTIP from (vi)'s own state
              (the ranks' θ rows joined) within 1e-10 of (vi)'s errors,
              (i)'s shrink-wrap from (vi)'s joined state before the
              shrink-wrap bitwise (vi)'s joined support after it, the
              two ranks' error series bitwise equal, the archive's
              layout (i)'s, no launch, at most 45 s; the exchanges'
              bytes,
              seconds and wait per iteration, s/iteration/restart beside
              (i)'s, each rank's start-up (on cuda:0,1 too where there
              are two cards); (v) simulate_ccd on its
              tutorial settings under fused_sht false: no launch, the CC
              within 1e-4 of max of the chain's kernel CC, seconds per
              stage. Run (iv) closes phase 13 and run (iii) phase 17.
     mesh     the device mesh (parallel/mesh.py), run inside phase 12 on
              the chain's invariants after its reconstruct stage, which
              is cut in depth to the tutorial settings' 4 restarts in one
              batch from seed 0 and is run (i)'s one-card reference. Two
              ranks share cuda:0 (their times measure correctness, not
              scaling; every line carries the card's nvidia-smi name and
              power limit): (i) the reconstruct worker on the same
              settings over 2 ranks: the initial densities the one-card
              batch's row for row, each rank's restarts bitwise a
              one-card MultiStartRunner run of its two rows (error series,
              final error), the first iteration within 1e-4 of the
              one-card batch (the largest difference of the series
              printed), every restart finite, the best > 0.75 to the
              truth, the archive's keys, dtypes and shapes the one-card
              archive's; (ii) and (vi) `python -m xframe_tpu_torch
              --distributed fxs reconstruct` as two processes with
              torchrun's variables on cuda:0, beside (i), 3 restarts of
              one cycle (a padded row trimmed): rank 0 alone writes,
              bitwise as in (i); (iii) a checkpoint after one chunk under 2 ranks
              resumed under 2 ranks, bitwise the uninterrupted 2-rank run,
              and the file (the whole batch) resumed in a one-card
              CheckpointingRunner; (iv) on the same 2 ranks the average
              worker on (i)'s archive against 1 card: angles and the
              averaged density within 1e-6 of max; (vii) with two cards or more, restarts/hour
              on cuda:0,1 against one card and `--device cuda:1` through
              the CLI, else a line saying they were not run. Run (v),
              after phase 17: the production problem over 2 ranks (rank 0
              phase 17's, the other built on its host grid), 2 restarts,
              HIO 20 + SW: finite, B8 on every rank, the gather's seconds
              and bytes.
 13. chain_2d  the 2D tutorial chain (settings tutorial_2d, a pentamer of
              disks) through select_worker + run on the card, uncut, in a
              temporary XFRAME_TPU_HOME: simulate_ccd (N = 256, M = 64,
              n_phi = 256, CC 256x256x256 float64) -> extract (M = 64) ->
              reconstruct (N = 128, M = 32, n_phi = 128, 8 restarts in
              chunks of 2, the 600-iteration schedule, SO_freedom on) ->
              average. No hand kernel lies on this path (torch.fft and
              batched matmuls, as the JAX package's jnp.fft and einsums).
              Lines chain_2d per stage: wall seconds and sub-stages, peak
              device memory, the device's busy share under torch.profiler
              (simulate, extract, average), the check against the port's
              CPU run: the CC on the card's density within 1e-5 of max
              (and the CPU's density builder disagreeing on at most 5e-3
              of the points), V_m V_m^dag of the card's archive within
              1e-6 of max, chunk 0's first-iteration errors from the same
              initial densities within 1e-4. chain_2d_fidelity: each
              restart and the average aligned to the truth, the best
              >= 0.88 and the average >= 0.91 (the JAX package's
              tutorial_2d chain on the CPU reached 0.9391 and 0.9689,
              scripts/rehearse_tutorial_2d.py). chain_2d_scale: one
              reconstruct batch at the simulate grid (256x256, M = 64),
              32 restarts, 100 ft-stab HIO iterations after 5: seconds,
              s/iteration/restart, peak memory, busy share over 10 more.
              Then phase precision's run (iv): the tutorial_2d worker on
              the chain's invariants in float64, 2 restarts, one cycle,
              its first iteration within 1e-9 of the CPU's.
 14. cli      the port as users start it, in a fresh XFRAME_TPU_HOME:
              `python -m xframe_tpu_torch --setup_home` and `--print_home`
              as subprocesses; the home copies of reconstruct/ and
              average/tutorial.json edited (CLI_RESTARTS = 2 restarts in
              one chunk from seed 0, one cycle HIO 30 + SW + ER 20 at the
              tutorial's full width, profiling.enable, generate_vtk_files
              1; the average without average_density.vts), so that the
              outputs show the home copy won; `fxs simulate_ccd tutorial`
              as a subprocess, then simulate_ccd, extract, reconstruct and
              average on their tutorial settings and `tutorial
              get_started` through xframe_tpu_torch.main.main() in this
              process, their launches counted. Checks: each run folder
              holds exactly its archive, settings.json, settings_merged.json
              and the .vts its settings ask for (simulate's
              model_density.vts, real_density_0.vts), the links
              ccd/tutorial/ccd.npz and invariants/tutorial/proj_data.npz
              point at the newest runs, the reconstruct run's settings.json
              is the home copy's text, real_density_0.vts decodes to the
              archive's real_density bitwise, the torch.profiler trace under
              <home>/traces names kernels of B1, B3, B4, B5 and B6 (LABELS),
              get_started launches B1. Line cli: seconds per stage,
              launches per stage, files, links, the trace's bytes, kernel
              events and kernels.
 15. correlate  the correlate worker on its tutorial settings
              (tutorial-1a: 2000 frames of 512x512, n_q 255 from the
              origin (255.2, 255.5), n_phi 1024, fc_n_max 70, batch 64)
              on the card, from .raw frames that the phase writes from
              --seed into a temporary folder: e(r)(1 + a cos 2(phi -
              phi_k)), a = 0.5, 5 % noise, 20 NaN pixels a frame, 12 dead
              (zero) pixels, 3 files missing and 2 short. Lines:
              correlate (seconds writing; the worker's setup, loop, reader
              wait, device batches, normalization, readback and save
              seconds; frames/s; archive bytes; peak device memory),
              correlate_checks, correlate_extract. Checks: the CC finite
              and C(q1,q2,D) = C(q2,q1,-D) within 1e-4 of max (float32
              sums); num_images_good the frames left good; the first 128
              frames through the card's Correlator within 1e-4 of max of
              a float64 numpy/scipy reference (map_coordinates order 1);
              2|F_2|/F_0 over D of every ring pair 2 or more apart, from
              ring 16 on and away from the dead pixels, within 1e-2 of
              a^2/2; extract (tutorial settings) on the archive: B_l
              finite and PSD (least eigenvalue printed).
 16. panel    PanelCorrelator on the nominal AGIPD-1M geometry (1,048,576
              pixels, n_q 128, n_phi 512), 256 seeded frames in batches of
              32 on the card (seconds, the gathered tensor's bytes, peak
              memory); the first batch also on the CPU, within 1e-4 of
              max (each departs from float64 by 2.3e-5 where the
              mask-CCF division by few overlapping bin pairs lifts the
              float32 rounding).
 17. production  make_demo_problem(256, 127, 320x640, newton_schulz_pallas,
              minimax schedule), 1 restart through the 600-iteration
              tutorial schedule (B8 three launches per iteration), then
              MTIP.finalize(best_rho) (B7 three launches); prints set-up
              seconds, s/iteration/restart, restarts/hour, peak device
              memory and the B_l fingerprint, and checks that finalize's W
              is the identity outside each order's window (1e-5) for every
              order that carries data (the odd orders carry none: B_l = 0,
              and their W, of scale 1e-20, is neither converged nor used).
              Then HIO 60 + SW + ER 40 from the same density on the default
              path (B4, B6 + B3), on k2_fwd=False (B11 + B1) and on
              k1_abs2=True (B12 and a Hankel matmul), each variant's
              s/iteration/restart beside the default's and its
              first-iteration errors within 1e-4 of the default's; replay
              against the default path over the same 100 iterations, as in
              phase 7; the 600-iteration run's best density aligned to the
              truth (correlation printed, not gated). Then phase
              precision's run (iii): the same problem in float64
              (make_demo_problem(..., real_dtype=float64, host=) on the
              float32 problem's host grid and true density, the stepwise
              iteration on the plain transforms), 1 restart, 10 HIO and
              finalize: B7 on complex64 copies of the three crop buckets,
              3 launches an iteration and 3 in finalize, B8 and every
              other kernel none; the first iteration within 1e-4 of the
              same with each crop through B7's plain version on the card,
              its distance to a float64 Newton-Schulz run printed;
              set-up, s/iteration, peak memory.

Every slice fails on a non-finite value, a final main error that does not
fall below half the mean of the first five, or launch counts that differ
from the ones its schedule implies; each path's counts are set to 0 just
before it runs and read just after.

Then a line {"kernels": [...]} (library_ms is null for every kernel: no
single PyTorch call computes any of these functions; launches are those of
the kernel's path plus the tutorial chain's, extract_options' and the
options, precision, cli and mesh phases', every rank's; the bf16 forms',
rows named with _bf16 at the end, those of phase bf16's run and
variants), the
nvidia-smi line, and the last line {"ok": true, "device": {...}}. Any
failed check exits non-zero. The whole run takes about fifteen minutes on
an H100, the build included. --seed (default 0) seeds the frames of phases
15 and 16.

`--kernel-shapes production` runs phases 1-3 only, every kernel at the
production cell's shapes (1 restart x 256 shells, L = 127, 320x640; B7 and
B8 at N_q = 256, L = 127, 1 restart), and prints no result line.
"""
from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

N_Q, L_MAX, N_THETA, N_PHI, N_RESTARTS = 128, 64, 256, 512, 2
KERNEL_SHAPES = {  # (restarts, shells, L, n_theta, n_phi) of the kernel phase
    "tutorial": (N_RESTARTS, N_Q, L_MAX, N_THETA, N_PHI),
    "production": (1, 256, 127, 320, 640),
}
NS_SHAPES = {  # (restarts, shells, L) of B7 and B8 in the kernel phase
    "tutorial": (N_RESTARTS, N_Q, L_MAX),
    "production": (1, 256, 127),
}
PROD = dict(n_q=256, l_max=127, n_theta=320, n_phi=640, restarts=1)
REL_TOL = 1e-4
REPLAY_TOL = 2e-5        # replay against eager (tests/test_replay_best.py)
FIDELITY_MIN = 0.9       # ground-truth correlation (tests/test_phasing.py)
# the worker phase: 4 restarts (half the tutorial's 8, which phase 12 runs)
# in the tutorial's chunks of 2, and the pipeline gates
# (tests/test_pipeline_integration.py:211,217)
WORKER_RESTARTS, WORKER_BATCH = 4, 2
BEST_MIN, AVERAGE_MIN = 0.75, 0.85
ALIGN_CPU_TOL = 1e-3     # the aligner on the card against the CPU
SW_CENTER_TOL = 1e-4     # SW_center on the card against the CPU, of max|ρ|
# the chain: the tutorial average against the truth (the JAX package's own
# tutorial chain reached 0.80, docs/performance.md:779); the small chain's
# extract on the CPU against the card, of max V_l V_l†; its shapes
CHAIN_MIN = 0.75
CHAIN_CPU_TOL = 1e-8
PIPELINE_SHAPES = {"types": ["sphere", "sphere"],
                   "centers": [[0, 0, 0], [30, 1.2, 0.7]],
                   "sizes": [20, 14], "densities": [1.0, 0.7],
                   "random_orientation": [False, False]}
# the 2D chain: the card against the port's CPU run (the CC of max, V_m V_m†
# of max, the first iteration's errors absolute) and the ground-truth
# correlations of the best restart and the average, 0.05 below the JAX
# package's own tutorial_2d chain on the CPU (best 0.9391, average 0.9689,
# scripts/rehearse_tutorial_2d.py --package jax); the scale line's batch
CHAIN_2D_CC_TOL, CHAIN_2D_GRAM_TOL, CHAIN_2D_ERR_TOL = 1e-5, 1e-6, 1e-4
CHAIN_2D_BEST_MIN, CHAIN_2D_AVERAGE_MIN = 0.88, 0.91
SCALE_2D = dict(restarts=32, iterations=100)
# the kernels at the shapes the tutorial's workers give them: (rows, L, n_θ,
# n_φ, kernels) — simulate_ccd's B1, B2, B3; extract's SHT-constraint
# options' B2 and B9 (512 radial points, L = 69 on its default grid)
WORKER_SHAPES = {
    "simulate": (512, 128, 256, 512,
                 ("sht_forward", "sht_inverse", "sht_forward_real_abs2")),
    "extract": (512, 69, 128, 256, ("sht_inverse", "sht_forward_real")),
}
# the worker, average and options phases write no .vts, so that their save
# seconds stay comparable with earlier runs'; the chain and cli phases
# write them
NO_VTK = {"reconstruct": {"files": {"reconstructions": {"options": {
              "generate_vtk_files": False}}}},
          "average": {"files": {"average_results": {"options": {
              "generate_average_vtk": False}}}}}
_GRID_DIMS = (-3, -2, -1)
NS_TOL = {"polar_unitary": 2e-3, "fused_projection_bucket": 5e-3}
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12   # H100 SXM: FP32 CUDA cores, HBM3
SHT_SOURCE = "xframe_tpu_torch/csrc/sht.cu"
MTIP_SOURCE = "xframe_tpu_torch/csrc/mtip.cu"
PROJ_SOURCE = "xframe_tpu_torch/csrc/projection.cu"
# fourier_transform.fused_bf16_tables: the bf16-table forms of B1-B6 and
# B9-B12 (the suffix of their names and launch counters)
BF16 = "_bf16"
BF16_PEAK_FLOPS = 989e12  # H100 SXM: dense BF16 on the tensor cores
BF16_FROM_F32 = 1e-5      # each form at least this far (of max) from float32
# each form against its plain version on the card (the plain SHT at
# mxu_dtype bf16), of max|plain|: the same bf16-rounded operands and float32
# sums in another order. Where the kernel computes an operand itself (an
# FFT's or a dense DFT's output: B1, B3, B9, B4's and B12's second stage)
# it may sit a float32 ulp from its plain twin's across a bf16 rounding
# boundary and round one bf16 step apart: the largest error, at the few
# sums that take such steps, reached 1.2e-3 (B1), 9.5e-4 (B4), 1.9e-4
# (B12), 7.3e-5 (B3) and 1.6e-5 (B9) on an NVIDIA H100 (tutorial and
# production shapes, FFT and dense routes); the others, whose operands come
# from the input or a float32 fold, stayed at 1.1e-6. BF16_TOL is about
# 3x those; BF16_RMS_TOL bounds the root mean square error, which rare
# steps leave small but a missing or wrong rounding of every operand would
# lift to the bf16 level (about 1e-3 of max)
BF16_TOL = {"sht_forward": 3e-3, "sht_inverse": 1e-5, "sht_forward_real": 1e-4,
            "sht_inverse_real": 1e-5, "sht_forward_real_abs2": 3e-4,
            "hankel_synthesize": 1e-5, "inverse_real_project_fwd": 3e-3,
            "inverse_real_project": 1e-5, "synthesize_abs2": 1e-3,
            "synthesize_update": REL_TOL}
BF16_RMS_TOL = 5e-5
KERNELS = (
    # name, launch counter, the path whose run counts its launches, source,
    # TPU kernel
    ("sht_forward", "forward", "fused", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:184"),
    ("sht_inverse", "inverse", "fused", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:212"),
    ("sht_forward_real_abs2", "forward_real_abs2", "fused", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:602"),
    ("inverse_real_project_fwd", "inverse_real_project_fwd", "fused",
     MTIP_SOURCE, "xframe_tpu/ops/pallas_mtip.py:241"),
    ("synthesize_update", "synthesize_update", "fused", MTIP_SOURCE,
     "xframe_tpu/ops/pallas_mtip.py:321"),
    ("hankel_synthesize", "hankel_synthesize", "fused", MTIP_SOURCE,
     "xframe_tpu/ops/pallas_mtip.py:115"),
    ("polar_unitary", "polar_unitary", "production", PROJ_SOURCE,
     "xframe_tpu/ops/pallas_kernels.py:88"),
    ("fused_projection_bucket", "fused_projection_bucket", "production",
     PROJ_SOURCE, "xframe_tpu/ops/pallas_kernels.py:119"),
    ("sht_forward_real", "forward_real", "stepwise", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:622"),
    ("sht_inverse_real", "inverse_real", "stepwise", SHT_SOURCE,
     "xframe_tpu/ops/pallas_sht.py:521"),
    ("inverse_real_project", "inverse_real_project", "k2_fwd", MTIP_SOURCE,
     "xframe_tpu/ops/pallas_mtip.py:179"),
    ("synthesize_abs2", "synthesize_abs2", "k1_abs2", MTIP_SOURCE,
     "xframe_tpu/ops/pallas_mtip.py:218"),
)
# the bf16 forms: the worker's run with fused_bf16_tables (phase bf16)
# launches B1-B6, B9 and B10 (finalize); B11 and B12 run on its MTIP's
# variants k2_fwd=False and k1_abs2=True
BF16_KERNELS = tuple(
    (name + BF16, counter + BF16, "bf16" + {
        "inverse_real_project": "_k2_fwd",
        "synthesize_abs2": "_k1_abs2"}.get(counter, ""), source, where)
    for name, counter, _, source, where in KERNELS
    if source in (SHT_SOURCE, MTIP_SOURCE))
# (substrings of a kernel's symbol, label): the first entry all of whose
# substrings occur names it (the kernels of csrc/; phase cli reads the
# reconstruct worker's trace with it, scripts/torch_profile_iteration.py
# its profiles)
LABELS = (
    (("hankel_gemm_kernel",), "B6 Hankel contraction"),
    # bf16 tables: the tensor-core GEMMs and the CUDA-core stages on bf16
    (("legendre_bf16_kernel", "ComplexOut"), "B6 Legendre GEMM bf16 (FFT)"),
    (("legendre_bf16_kernel", "UpdateOut"), "B5 Legendre GEMM bf16 (FFT)"),
    (("legendre_bf16_kernel", "InverseOut"), "B2 Legendre GEMM bf16 (FFT)"),
    (("legendre_bf16_kernel", "RealOut"), "B10 Legendre GEMM bf16 (FFT)"),
    (("legendre_bf16_kernel", "ProjectOut"), "B11 Legendre GEMM bf16 (FFT)"),
    (("legendre_bf16_kernel", "Abs2FftOut"), "B12 Legendre GEMM bf16 (FFT)"),
    (("quadrature_bf16_kernel<0>",), "B1 quadrature GEMM bf16"),
    (("quadrature_bf16_kernel<1>",), "B9 quadrature GEMM bf16"),
    (("quadrature_bf16_kernel<2>",), "B3 quadrature GEMM bf16"),
    (("quadrature_bf16_kernel<3>",), "B12 quadrature GEMM bf16 (FFT)"),
    (("synthesis_kernel", "UpdateOut", "bfloat16"), "B5 bf16 (dense)"),
    (("synthesis_kernel", "InverseOut", "bfloat16"), "B2 bf16 (dense)"),
    (("synthesis_kernel", "RealOut", "bfloat16"), "B10 bf16 (dense)"),
    (("synthesis_kernel", "ComplexOut", "bfloat16"),
     "B6 synthesis bf16 (dense)"),
    (("synthesis_kernel", "Abs2Out", "bfloat16"), "B12 (a) bf16 (dense)"),
    (("project_dft_kernel<false,", "bfloat16"), "B11 bf16 (dense)"),
    (("quadrature_kernel<true,", "bfloat16"), "B12 (b) bf16 (dense)"),
    (("quadrature_kernel<false,", "bfloat16"), "B4 (b) bf16"),
    (("project_fft_kernel", "bfloat16"), "B4 (a) FFT bf16"),
    (("project_dft_kernel<true,", "bfloat16"), "B4 (a) dense bf16"),
    (("analysis_kernel<0,", "bfloat16"), "B1 bf16 (dense)"),
    (("analysis_kernel<1,", "bfloat16"), "B9 bf16 (dense)"),
    (("analysis_kernel<2,", "bfloat16"), "B3 bf16 (dense)"),
    # float32 tables
    (("legendre_gemm_kernel", "ComplexOut"), "B6 Legendre GEMM (FFT)"),
    (("synthesis_fft_kernel", "ComplexOut"), "B6 FFTs + output (FFT)"),
    (("legendre_gemm_kernel", "UpdateOut"), "B5 Legendre GEMM (FFT)"),
    (("synthesis_fft_kernel", "UpdateOut"), "B5 FFTs + update (FFT)"),
    (("synthesis_kernel", "UpdateOut"), "B5 (dense)"),
    (("legendre_gemm_kernel", "InverseOut"), "B2 Legendre GEMM (FFT)"),
    (("synthesis_fft_kernel", "InverseOut"), "B2 FFTs + output (FFT)"),
    (("synthesis_kernel", "InverseOut"), "B2 (dense)"),
    (("legendre_gemm_kernel", "RealOut"), "B10 Legendre GEMM (FFT)"),
    (("synthesis_fft_kernel", "RealOut"), "B10 FFTs + output (FFT)"),
    (("synthesis_kernel", "RealOut"), "B10 (dense)"),
    (("synthesis_kernel", "ComplexOut"), "B6 synthesis (dense)"),
    (("legendre_gemm_kernel", "ProjectOut"), "B11 Legendre GEMM (FFT)"),
    (("synthesis_fft_kernel", "ProjectOut"), "B11 FFTs + projection (FFT)"),
    (("project_dft_kernel<false",), "B11 (dense)"),
    (("legendre_gemm_kernel", "Abs2FftOut"), "B12 Legendre GEMM (FFT)"),
    (("synthesis_fft_kernel", "Abs2FftOut"),
     "B12 FFTs + output + |psi|^2 FFTs (FFT)"),
    (("quadrature_gemm_kernel<3>",), "B12 quadrature GEMM (FFT)"),
    (("synthesis_kernel", "Abs2Out"), "B12 (a) (dense)"),
    (("quadrature_kernel<true",), "B12 (b) (dense)"),
    (("quadrature_kernel<false",), "B4 (b)"),
    (("project_fft_kernel",), "B4 (a) FFT"),
    (("project_dft_kernel<true",), "B4 (a) dense"),
    (("analysis_fft_kernel<0,",), "B1 FFT"),
    (("quadrature_gemm_kernel<0>",), "B1 quadrature GEMM"),
    (("analysis_fft_kernel<1,",), "B9 FFT"),
    (("quadrature_gemm_kernel<1>",), "B9 quadrature GEMM"),
    (("analysis_fft_kernel<2,",), "B3 FFT"),
    (("quadrature_gemm_kernel<2>",), "B3 quadrature GEMM"),
    (("analysis_kernel<0",), "B1 (dense)"),
    (("analysis_kernel<1",), "B9 (dense)"),
    (("analysis_kernel<2",), "B3 (dense)"),
    (("project_kernel",), "B8"),
    (("polar_kernel",), "B7"),
)


def label(name):
    """The hand kernel a symbol belongs to, or None."""
    for parts, text in LABELS:
        if all(p in name for p in parts):
            return text
    return None


# B5's cases: (method, ft_stab, weights, the linked ft-stab gate per
# restart or None): the plane form, the shared grid (a non-radial initial
# support) and the gate 0 and 1 across two restarts
UPDATE_CASES = (("HIO", True, "plane", None), ("ER", True, "plane", None),
                ("RAAR", False, "plane", None), ("HIO", True, "grid", None),
                ("HIO", True, "plane", (0.0, 1.0)))


class CheckFailed(RuntimeError):
    pass


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() over `reps` timed calls (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
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
    times.sort()
    return times[len(times) // 2]


def compare(torch, np, name, got, want, keep=None, scales=None, tol=REL_TOL,
            absolute=False):
    """max|got − want| (over `keep`) and its ratio to max|want| (or to the
    given scale, or 1 if absolute), for each output of a kernel; fails above
    tol. → (max absolute error over the grid and coefficient outputs, the
    relative error of every output, sums included)."""
    errs, rels = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g - w).abs()
        if keep is not None and diff.shape == keep.shape:
            diff = diff[keep]
        err = float(diff.max())
        scale = 1.0 if absolute else float(
            w.abs().max() if scales is None or scales[i] is None
            else scales[i].max())
        check(np.isfinite(err) and np.isfinite(scale) and scale > 0,
              f"{name}: non-finite or zero output")
        errs.append(err)
        rels.append(err / scale)
    check(max(rels) <= tol, f"{name}: relative errors {rels} exceed {tol}")
    return max(e for e, g in zip(errs, got) if g.dim() >= 3), rels


# ------------------------------------------------------------------ bounds
def bound(flop, nbytes):
    """→ (least milliseconds, what binds it)."""
    t_op, t_by = flop / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def kernel_work(name, rows, n_theta, n_phi, l_max, n_q=None,
                weights="plane"):
    """(FLOP, bytes) that one call of an SHT or fused-iteration kernel on
    `rows` rows needs, whatever its algorithm: each φ-transform of a θ line
    as an FFT (5·P·log2 P FLOP for complex data, half that for real data
    or a real output), the Legendre stages over the (l, m) triangle only
    (4 FLOP per complex coefficient × real P̄ multiply-add; m ≥ 0 only for
    real fields), and each input, Legendre table and output counted once.
    The FFT routes of B1-B6 and B9-B12 run FFTs; every dense route runs
    dense φ-DFTs onto the 2L+1 bins, 10-45× the FFT's operations at the
    tutorial and production shapes. weights "grid": B5 reads the
    (n_q, n_θ, n_φ) weight grid the restarts share, not the plane."""
    R, T, P = rows, n_theta, n_phi
    n_m, n_l = 2 * l_max + 1, l_max + 1
    tri, tri_pos = n_l * n_l, n_l * (n_l + 1) // 2   # (l, m): all m, m ≥ 0
    grid, coef = R * T * P, R * n_m * n_l
    leg = R * T * tri * 4
    leg_pos = R * T * tri_pos * 4
    cfft = R * T * 5 * P * math.log2(P)
    rfft = cfft / 2
    table, table_pos = T * tri * 4, T * tri_pos * 4
    w_plane = (n_q or 0) * T * (P if weights == "grid" else 1) * 4
    work = {  # (FLOP, bytes)
        "sht_forward": (cfft + leg, 8 * grid + 8 * coef + table),
        "sht_inverse": (leg + cfft, 8 * coef + 8 * grid + table),
        "sht_forward_real": (rfft + leg_pos,
                             4 * grid + 8 * coef + table_pos),
        "sht_inverse_real": (leg_pos + rfft,
                             8 * coef + 4 * grid + table_pos),
        "sht_forward_real_abs2": (3 * grid + rfft + leg_pos,
                                  8 * grid + 8 * coef + table_pos),
        "inverse_real_project_fwd": (leg_pos + rfft + cfft + leg,
                                     16 * coef + 8 * grid + w_plane
                                     + table + table_pos),
        "synthesize_update": (leg + cfft,
                              8 * coef + 17 * grid + w_plane + table),
        "inverse_real_project": (leg_pos + rfft,
                                 8 * coef + 16 * grid + w_plane
                                 + table_pos),
        "synthesize_abs2": (leg + cfft + 3 * grid + rfft + leg_pos,
                            16 * coef + 8 * grid + table + table_pos),
    }
    if name == "hankel_synthesize":
        # + the Hankel contraction over the (l, m) triangle: per restart
        # and order an (n_q × n_q) complex matrix times n_q × (2l+1)
        b = R // n_q
        flop, nbytes = work["sht_inverse"]
        return (flop + b * n_q * n_q * tri * 8,
                nbytes + 8 * coef + n_q * n_q * n_l * 8)
    return work[name]


def ns_work(name, buckets, restarts, n_q, n_steps, n_cubic):
    """(FLOP, bytes) of one projection's B7 or B8 calls over `buckets`
    [(l_lo, l_hi, h)], 8 FLOP per complex multiply-add: per quintic
    Newton–Schulz step A = X†X and A² (Hermitian, half of each computed)
    and X·(bA + cA²), 2c³ multiply-adds; per cubic step 1.5c³. B8 adds
    B = PD·I and V·W."""
    flop = nbytes = 0
    for (l_lo, l_hi, h) in buckets:
        g, c = restarts * (l_hi - l_lo + 1), 2 * h + 1
        steps = 2 * (n_steps - n_cubic) + 1.5 * n_cubic
        flop += g * steps * c ** 3 * 8
        if name == "polar_unitary":
            nbytes += 2 * g * c * c * 8
        else:
            flop += g * 2 * c * c * n_q * 8
            nbytes += 2 * g * n_q * c * 8 + 2 * (l_hi - l_lo + 1) \
                * n_q * c * 8 + (l_hi - l_lo + 1) * n_q * 4
    return flop, nbytes


# ------------------------------------------------------------------ kernels
def kernel_fixture(torch, np, shapes):
    """FusedSHT and FusedIteration at the kernel phase's shapes, with a
    midpoint Hankel transform and a reciprocal weight plane, on the card."""
    from xframe_tpu_torch.ops.fused_mtip import FusedIteration
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    from xframe_tpu_torch.ops.hankel import (SphericalHankelTransform,
                                             generate_weights)
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    b, n_q, l_max, n_theta, n_phi = KERNEL_SHAPES[shapes]
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device="cuda")
    fused = FusedSHT(sht)
    hankel = SphericalHankelTransform(
        generate_weights(l_max, n_q, 2.0, 3, "midpoint"), r_max=100.0,
        reciprocity_coefficient=2.0, device="cuda")
    rng = np.random.default_rng(0)
    w_rec = rng.uniform(0.1, 1.0, (n_q, n_theta)).astype(np.float32)
    fi = FusedIteration(fused, w_rec=w_rec, hankel=hankel)
    return sht, fused, fi, rng, (b, n_q)


def time_case(torch, name, kern, plain, args, work, shapes, emit_extra):
    ms = cuda_ms(torch, lambda: kern(*args), 10)
    plain_ms = cuda_ms(torch, lambda: plain(*args), 10)
    bound_ms, bound_by = bound(*work)
    r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             gflop=work[0] / 1e9, mbytes=work[1] / 1e6)
    emit(phase="kernel", name=name, shapes=shapes, **emit_extra, **r)
    return r


def phase_kernels(torch, np, shapes):
    """Phase 3: the twelve kernels against their plain versions."""
    sht, fused, fi, rng, lead = kernel_fixture(torch, np, shapes)
    L = sht.l_max
    grid = lead + (sht.n_theta, sht.n_phi)
    coef = lead + (sht.n_m, L + 1)
    rows = lead[0] * lead[1]
    dims = (rows, sht.n_theta, sht.n_phi, L)

    def cgrid():
        return torch.as_tensor((rng.standard_normal(grid)
                                + 1j * rng.standard_normal(grid)).astype(
                                    np.complex64), device="cuda")

    def ccoef():
        c = rng.standard_normal(coef) + 1j * rng.standard_normal(coef)
        return torch.as_tensor((c * sht.lm_mask).astype(np.complex64),
                               device="cuda")

    f, c = cgrid(), ccoef()
    # name → (kernel, plain, inputs)
    cases = {
        "sht_forward": (fused.forward, sht.forward, (f,)),
        "sht_inverse": (fused.inverse, sht.inverse, (c,)),
        "sht_forward_real": (fused.forward_real, sht.forward_real,
                             (f.abs().contiguous(),)),
        "sht_inverse_real": (fused.inverse_real, sht.inverse_real, (c,)),
        "sht_forward_real_abs2": (fused.forward_real_abs2,
                                  sht.forward_real_abs2, (f,)),
        "hankel_synthesize": (fi.hankel_synthesize,
                              fi.hankel_synthesize_plain, (c,)),
        "inverse_real_project_fwd": (fi.inverse_real_project_fwd,
                                     fi.inverse_real_project_fwd_plain,
                                     (c, cgrid())),
        "synthesize_abs2": (fi.synthesize_abs2, fi.synthesize_abs2_plain,
                            (c,)),
    }
    results = {}
    for name, (kern, plain, args) in cases.items():
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, rels = compare(torch, np, name, got, want)
        extra = dict(shape=list(args[0].shape), rel_errs=rels,
                     max_abs_err=err)
        route = dict(inverse_real_project_fwd=fi.projection_route,
                     hankel_synthesize=fi.synthesis_route,
                     sht_inverse=fused.synthesis_route,
                     sht_inverse_real=fused.synthesis_route,
                     sht_forward=fused.analysis_route,
                     sht_forward_real=fused.analysis_route,
                     sht_forward_real_abs2=fused.analysis_route,
                     synthesize_abs2=fi.synthesis_route).get(name)
        if route is not None:
            extra["route"] = route
            check(route == "fft", f"{name} at {shapes} shapes runs the "
                  f"{route} route, not the FFT")
        results[name] = dict(max_abs_err=err, rel_err=max(rels))
        results[name].update(time_case(
            torch, name, kern, plain, args,
            kernel_work(name, *dims, n_q=lead[1]), shapes, extra))

    # B11 writes ψ_p = ψ·√(I_new/|ψ|²), 0 where I_new < 0: compared away
    # from I_new = 0, where √ turns a rounding difference δ of the synthesis
    # into one of √δ; the sums are held everywhere
    name = "inverse_real_project"
    check(fi.synthesis_route == "fft", f"{name} at {shapes} shapes runs the "
          f"{fi.synthesis_route} route, not the FFT")
    results[name] = project_case(torch, np, sht, fi, c, cgrid(), dims,
                                 lead[1], shapes, fi.synthesis_route)

    for case in UPDATE_CASES:
        err, r = update_case(torch, np, rng, sht, fi, lead, case, shapes)
        prev = results.setdefault("synthesize_update",
                                  dict(max_abs_err=err, **r))
        prev["max_abs_err"] = max(prev["max_abs_err"], err)
    phase_dense(torch, np, rng, shapes, fi.hankel)
    del sht, fused, fi
    results.update(phase_bf16_kernels(torch, np, shapes))
    if shapes == "tutorial":
        for label in WORKER_SHAPES:
            results.update(phase_worker_kernels(torch, np, label))

    for ns_shapes in (("tutorial", "production") if shapes == "tutorial"
                      else ("production",)):
        results.update(phase_ns_kernels(torch, np, rng, ns_shapes))
    return results


def phase_worker_kernels(torch, np, label):
    """The SHT kernels at the shapes a tutorial worker gives them
    (WORKER_SHAPES[label]) against their plain versions on the card, 1e-4
    of max, timed, with their bound. → {"<name> (<label>)": result}."""
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    rows, l_max, n_theta, n_phi, names = WORKER_SHAPES[label]
    sht = SphericalHarmonicTransform(l_max, n_theta, n_phi, device="cuda")
    fused = FusedSHT(sht)
    grid = (rows, n_theta, n_phi)
    f = torch.complex(torch.randn(grid, device="cuda"),
                      torch.randn(grid, device="cuda"))
    c = torch.complex(torch.randn((rows, sht.n_m, l_max + 1), device="cuda"),
                      torch.randn((rows, sht.n_m, l_max + 1), device="cuda"))
    c = c * torch.as_tensor(sht.lm_mask, device="cuda")
    cases = {  # name → (kernel, plain, input, route)
        "sht_forward": (fused.forward, sht.forward, f, fused.analysis_route),
        "sht_inverse": (fused.inverse, sht.inverse, c,
                        fused.synthesis_route),
        "sht_forward_real": (fused.forward_real, sht.forward_real,
                             f.real.contiguous(), fused.analysis_route),
        "sht_forward_real_abs2": (fused.forward_real_abs2,
                                  sht.forward_real_abs2, f,
                                  fused.analysis_route)}
    results = {}
    for name in names:
        kern, plain, arg, route = cases[name]
        got, want = kern(arg), plain(arg)
        torch.cuda.synchronize()
        err, rels = compare(torch, np, f"{name} ({label} shapes)", (got,),
                            (want,))
        del got, want
        check(route == "fft", f"{name} at {label} shapes runs the {route} "
              "route, not the FFT")
        r = time_case(torch, name, kern, plain, (arg,),
                      kernel_work(name, rows, n_theta, n_phi, l_max), label,
                      dict(shape=list(arg.shape), rel_errs=rels,
                           max_abs_err=err, route=route))
        results[f"{name} ({label})"] = dict(r, max_abs_err=err,
                                            rel_err=max(rels))
    return results


def project_case(torch, np, sht, fi, c, psi, dims, n_q, shapes, route):
    """B11 against its plain version, and timed. It writes ψ_p =
    ψ·√(I_new/|ψ|²), 0 where I_new < 0: compared away from I_new = 0, where
    √ turns a rounding difference δ of the synthesis into one of √δ; the
    sums are held everywhere. → its result entry."""
    name = "inverse_real_project"
    i_new = sht.inverse_real(c)
    keep = i_new.abs() > 1e-2 * float(i_new.abs().max())
    got, want = fi.inverse_real_project(c, psi), \
        fi.inverse_real_project_plain(c, psi)
    torch.cuda.synchronize()
    err, rels = compare(torch, np, f"{name} {route}", got, want, keep)
    r = dict(max_abs_err=err, rel_err=max(rels))
    r.update(time_case(
        torch, name, fi.inverse_real_project, fi.inverse_real_project_plain,
        (c, psi), kernel_work(name, *dims, n_q=n_q), shapes,
        dict(route=route, shape=list(psi.shape), rel_errs=rels,
             max_abs_err=err, points_left_out=int(keep.numel() - keep.sum()),
             points_negative=int((i_new < 0).sum()), points=keep.numel())))
    return r


def update_case(torch, np, rng, sht, fi, lead, case, shapes):
    """B5's case (method, ft_stab, weights, gates) of UPDATE_CASES against
    its plain version, thresholds at the scale of the synthesized density,
    and timed. A gated case takes one gate per restart, so a single
    restart's rows split into two restarts of half the shells; it is also
    held bitwise against the ungated kernel: gate 1 equals the kernel with
    ft-stab, gate 0 the kernel without. → (max abs error, timing)."""
    from xframe_tpu_torch.ops.fused_mtip import away_from_thresholds
    from xframe_tpu_torch.projects.fxs.projections import RealConstraint
    method, ft_stab, weights, gates = case
    if gates is not None and lead[0] != len(gates):
        lead = (len(gates), lead[0] * lead[1] // len(gates))
    grid = lead + (sht.n_theta, sht.n_phi)
    coef = lead + (sht.n_m, sht.l_max + 1)
    d = torch.as_tensor(((rng.standard_normal(coef)
                          + 1j * rng.standard_normal(coef)) * sht.lm_mask)
                        .astype(np.complex64), device="cuda")
    rho_in = torch.as_tensor((rng.standard_normal(grid)
                              + 1j * rng.standard_normal(grid))
                             .astype(np.complex64), device="cuda")
    support = torch.as_tensor(rng.uniform(size=grid) > 0.4, device="cuda")
    w_shape = lead[1:] + ((sht.n_theta, sht.n_phi) if weights == "grid"
                          else (sht.n_theta,))
    w = torch.as_tensor(rng.uniform(0.1, 1.0, w_shape), dtype=torch.float32,
                        device="cuda")
    c_phase = torch.as_tensor(np.exp(1j * np.array([0.7, -2.1])[:lead[0]]),
                              dtype=torch.complex64, device="cuda")
    scale = float(sht.inverse(d).abs().std())
    rc = RealConstraint(threshold_low=0.05 * scale, limit_imag=0.3 * scale)
    gate = None if gates is None else torch.tensor(gates, device="cuda")
    kw = dict(method=method, ft_stab=ft_stab, real_constraint=rc,
              ft_gate=gate)
    args = (d, rho_in, support, w, 0.6, c_phase)
    got = fi.synthesize_update(*args, **kw)
    want = fi.synthesize_update_plain(*args, **kw)
    rp, _ = fi.pre_constraint_plain(d, rho_in, c_phase, ft_stab=ft_stab,
                                    ft_gate=gate)
    keep = away_from_thresholds(rp, rc, 1e-4 * float(rp.abs().max()))
    # Σwρ² and Σwρ cancel down to ~√N of their terms, where one of the
    # ~N·1e-7 points that flip at a threshold weighs 1e-4; they are held to
    # the sums of the terms' magnitudes instead
    new = want[0].abs()
    w3 = w[..., None] if w.dim() == 2 else w
    scales = (None, None, None, (w3 * new * new).sum((-3, -2, -1)),
              (w3 * new).sum((-3, -2, -1)))
    torch.cuda.synchronize()
    label = f"synthesize_update {method} {weights} gates {gates}"
    err, rels = compare(torch, np, label, got, want, keep, scales)
    bitwise = {}
    if gates is not None:
        # gate g on restart b: that restart's rows bitwise as the kernel
        # with ft-stab (g = 1) or without (g = 0)
        ungated = {True: fi.synthesize_update(*args, **dict(kw, ft_gate=None)),
                   False: fi.synthesize_update(*args, **dict(
                       kw, ft_gate=None, ft_stab=False))}
        for b, g in enumerate(gates):
            ref = ungated[g == 1.0]
            bitwise[f"restart {b} gate {g}"] = all(
                bool(torch.equal(x[b], y[b])) for x, y in zip(got, ref))
        check(all(bitwise.values()), f"{label}: not bitwise the ungated "
              f"kernel: {bitwise}")
    rows = lead[0] * lead[1]
    r = time_case(torch, "synthesize_update",
                  lambda *a: fi.synthesize_update(*a, **kw),
                  lambda *a: fi.synthesize_update_plain(*a, **kw), args,
                  kernel_work("synthesize_update", rows, sht.n_theta,
                              sht.n_phi, sht.l_max, n_q=lead[1],
                              weights=weights),
                  shapes, dict(method=method, ft_stab=ft_stab,
                               weights=weights, gates=gates,
                               bitwise_vs_ungated=bitwise or None,
                               route=fi.synthesis_route,
                               shape=list(rho_in.shape), rel_errs=rels,
                               max_abs_err=err,
                               points_left_out=int(keep.numel() - keep.sum()),
                               points=keep.numel()))
    return err, r


def dense_fixture(torch, np, rng, shapes, hankel=None):
    """The kernel phase's rows and L on a grid whose n_phi has a prime
    factor other than 2, 3 and 5 (65x130 at L = 64, 133x266 at L = 127):
    → (SphericalHarmonicTransform, FusedIteration with a weight plane and
    `hankel` (the kernel fixture's where None), (restarts, shells))."""
    from xframe_tpu_torch.ops.fused_mtip import FusedIteration
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    from xframe_tpu_torch.ops.hankel import (SphericalHankelTransform,
                                             generate_weights)
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    b, n_q, L = KERNEL_SHAPES[shapes][:3]
    n_theta, n_phi = (65, 130) if L == 64 else (L + 6, 2 * L + 12)
    if hankel is None:
        hankel = SphericalHankelTransform(
            generate_weights(L, n_q, 2.0, 3, "midpoint"), r_max=100.0,
            reciprocity_coefficient=2.0, device="cuda")
    sht = SphericalHarmonicTransform(L, n_theta, n_phi, device="cuda")
    fi = FusedIteration(FusedSHT(sht), w_rec=rng.uniform(
        0.1, 1.0, (n_q, n_theta)).astype(np.float32), hankel=hankel)
    return sht, fi, (b, n_q)


def phase_dense(torch, np, rng, shapes, hankel):
    """B1, B9, B3, B2, B10, B4, B6, B12, B11 and B5 on their dense routes:
    the kernel phase's rows and L on a grid whose n_phi has a prime factor
    other than 2, 3 and 5 (65x130 at L = 64, 133x266 at L = 127), against
    the plain versions at REL_TOL (B11 away from I_new = 0, B5 in one case,
    HIO with ft-stab)."""
    sht, fi, (b, n_q) = dense_fixture(torch, np, rng, shapes, hankel)
    fused = fi.f
    L, n_theta, n_phi = sht.l_max, sht.n_theta, sht.n_phi
    check(fused.analysis_route == fused.synthesis_route
          == fi.projection_route == fi.synthesis_route == "dense",
          f"n_phi = {n_phi} runs the {fused.analysis_route} analysis, the "
          f"{fused.synthesis_route} inverse, the {fi.projection_route} "
          f"projection and the {fi.synthesis_route} synthesis")
    grid, coef = (b, n_q, n_theta, n_phi), (b, n_q, sht.n_m, L + 1)
    c = torch.as_tensor(((rng.standard_normal(coef)
                          + 1j * rng.standard_normal(coef)) * sht.lm_mask)
                        .astype(np.complex64), device="cuda")
    psi = torch.as_tensor((rng.standard_normal(grid)
                           + 1j * rng.standard_normal(grid))
                          .astype(np.complex64), device="cuda")
    for name, kern, plain, args in (
            ("sht_forward", fused.forward, sht.forward, (psi,)),
            ("sht_forward_real", fused.forward_real, sht.forward_real,
             (psi.abs().contiguous(),)),
            ("sht_forward_real_abs2", fused.forward_real_abs2,
             sht.forward_real_abs2, (psi,)),
            ("sht_inverse", fused.inverse, sht.inverse, (c,)),
            ("sht_inverse_real", fused.inverse_real, sht.inverse_real, (c,)),
            ("inverse_real_project_fwd", fi.inverse_real_project_fwd,
             fi.inverse_real_project_fwd_plain, (c, psi)),
            ("hankel_synthesize", fi.hankel_synthesize,
             fi.hankel_synthesize_plain, (c,)),
            ("synthesize_abs2", fi.synthesize_abs2, fi.synthesize_abs2_plain,
             (c,))):
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err, rels = compare(torch, np, f"{name} dense", got, want)
        time_case(torch, name, kern, plain, args,
                  kernel_work(name, b * n_q, n_theta, n_phi, L, n_q=n_q),
                  shapes, dict(route="dense", shape=list(psi.shape),
                               rel_errs=rels, max_abs_err=err))
    project_case(torch, np, sht, fi, c, psi, (b * n_q, n_theta, n_phi, L),
                 n_q, shapes, "dense")
    for case in (UPDATE_CASES[0],) + UPDATE_CASES[3:]:
        update_case(torch, np, rng, sht, fi, (b, n_q), case, shapes)


# ------------------------------------------------------------ bf16 tables
def bf16_work(name, rows, n_theta, n_phi, l_max, n_q=None, route="fft"):
    """(FLOP on the tensor cores, FLOP on CUDA cores, bytes) of one call of
    a kernel's bf16 form: kernel_work's FLOP with its Legendre stages on
    the tensor cores on the FFT route (all but B4's legendre_pos and
    quadrature_kernel), on CUDA cores on the dense route, and its bytes
    with the Legendre tables at two bytes a value."""
    flop, nbytes = kernel_work(name, rows, n_theta, n_phi, l_max, n_q=n_q)
    n_l = l_max + 1
    tri, tri_pos = n_l * n_l, n_l * (n_l + 1) // 2
    leg, leg_pos = rows * n_theta * tri * 4, rows * n_theta * tri_pos * 4
    table, table_pos = n_theta * tri * 4, n_theta * tri_pos * 4
    leg_flop, table_bytes = {
        "sht_forward": (leg, table), "sht_inverse": (leg, table),
        "sht_forward_real": (leg_pos, table_pos),
        "sht_inverse_real": (leg_pos, table_pos),
        "sht_forward_real_abs2": (leg_pos, table_pos),
        "hankel_synthesize": (leg, table),
        "inverse_real_project_fwd": (leg_pos + leg, table + table_pos),
        "synthesize_update": (leg, table),
        "inverse_real_project": (leg_pos, table_pos),
        "synthesize_abs2": (leg + leg_pos, table + table_pos)}[name]
    mma = leg_flop if route == "fft" and name != "inverse_real_project_fwd" \
        else 0
    return mma, flop - mma, nbytes - table_bytes / 2


def bf16_bound(mma, cuda_flop, nbytes):
    """→ (least milliseconds, what binds it): the larger of the tensor-core
    FLOP over 989 TFLOP/s, the CUDA-core FLOP over 67 TFLOP/s and the bytes
    over 3.35 TB/s."""
    t = {"operations": max(mma / BF16_PEAK_FLOPS, cuda_flop / PEAK_FLOPS)
         * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(t, key=t.get)
    return t[by], by


def bf16_forms(torch, np, rng, sht, fi32, lead, shapes, route):
    """The ten bf16 forms on `route` at `lead` + the transform's shapes:
    each against its plain version on the card (FusedSHT.plain, the
    FusedIteration's *_plain methods) within BF16_TOL[name] of max, more
    than BF16_FROM_F32 of max from the float32 form (fi32's) on the same
    inputs, timed beside its plain version, with its bound (bf16_work).
    B11 is compared away from I_new = 0, B5 (HIO, ft-stab, the weight
    plane) away from the real constraint's thresholds, as their float32
    forms. → {name: result}."""
    from xframe_tpu_torch.ops.fused_mtip import (FusedIteration,
                                                 away_from_thresholds)
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    from xframe_tpu_torch.projects.fxs.projections import RealConstraint
    fused = FusedSHT(sht, table_dtype=torch.bfloat16)
    fi = FusedIteration(fused, w_rec=fi32._w_rec, hankel=fi32.hankel)
    f32, plain = fi32.f, fused.plain
    check(fused.analysis_route == fused.synthesis_route
          == fi.projection_route == route,
          f"bf16 forms at {shapes}: not all on the {route} route")
    check(fused._PW.dtype == fused._P_t.dtype == torch.bfloat16,
          "the bf16 FusedSHT's Legendre tables are not bf16")
    L = sht.l_max
    grid = lead + (sht.n_theta, sht.n_phi)
    coef = lead + (sht.n_m, L + 1)

    def cx(shape, mask=False):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor((x * sht.lm_mask if mask else x).astype(
            np.complex64), device="cuda")
    f, c, psi = cx(grid), cx(coef, True), cx(grid)
    i_new = plain.inverse_real(c)
    away = i_new.abs() > 1e-2 * float(i_new.abs().max())
    d, rho_in = cx(coef, True), cx(grid)
    support = torch.as_tensor(rng.uniform(size=grid) > 0.4, device="cuda")
    w = torch.as_tensor(rng.uniform(0.1, 1.0, lead[1:] + (sht.n_theta,)),
                        dtype=torch.float32, device="cuda")
    c_phase = torch.as_tensor(np.exp(1j * np.array([0.7, -2.1])[:lead[0]]),
                              dtype=torch.complex64, device="cuda")
    scale = float(plain.inverse(d).abs().std())
    rc = RealConstraint(threshold_low=0.05 * scale, limit_imag=0.3 * scale)
    kw = dict(method="HIO", ft_stab=True, real_constraint=rc)
    rp, _ = fi.pre_constraint_plain(d, rho_in, c_phase, ft_stab=True)
    clear = away_from_thresholds(rp, rc, 1e-4 * float(rp.abs().max()))
    upd = (d, rho_in, support, w, 0.6, c_phase)
    cases = {  # name → (bf16 form, float32 form, plain version, inputs, keep)
        "sht_forward": (fused.forward, f32.forward, plain.forward, (f,),
                        None),
        "sht_inverse": (fused.inverse, f32.inverse, plain.inverse, (c,),
                        None),
        "sht_forward_real": (fused.forward_real, f32.forward_real,
                             plain.forward_real, (f.abs().contiguous(),),
                             None),
        "sht_inverse_real": (fused.inverse_real, f32.inverse_real,
                             plain.inverse_real, (c,), None),
        "sht_forward_real_abs2": (fused.forward_real_abs2,
                                  f32.forward_real_abs2,
                                  plain.forward_real_abs2, (f,), None),
        "hankel_synthesize": (fi.hankel_synthesize, fi32.hankel_synthesize,
                              fi.hankel_synthesize_plain, (c,), None),
        "inverse_real_project_fwd": (fi.inverse_real_project_fwd,
                                     fi32.inverse_real_project_fwd,
                                     fi.inverse_real_project_fwd_plain,
                                     (c, psi), None),
        "inverse_real_project": (fi.inverse_real_project,
                                 fi32.inverse_real_project,
                                 fi.inverse_real_project_plain, (c, psi),
                                 away),
        "synthesize_abs2": (fi.synthesize_abs2, fi32.synthesize_abs2,
                            fi.synthesize_abs2_plain, (c,), None),
        "synthesize_update": (
            lambda *a: fi.synthesize_update(*a, **kw),
            lambda *a: fi32.synthesize_update(*a, **kw),
            lambda *a: fi.synthesize_update_plain(*a, **kw), upd, clear),
    }
    rows = lead[0] * lead[1]
    results = {}
    for name, (kern, kern32, plain_fn, args, keep) in cases.items():
        got, want, ref = kern(*args), plain_fn(*args), kern32(*args)
        torch.cuda.synchronize()
        got, want, ref = (x if isinstance(x, tuple) else (x,)
                          for x in (got, want, ref))
        scales = None
        if name == "synthesize_update":
            # Σwρ² and Σwρ cancel: held to the sums of the terms' magnitudes
            new = want[0].abs()
            scales = (None, None, None,
                      (w[..., None] * new * new).sum((-3, -2, -1)),
                      (w[..., None] * new).sum((-3, -2, -1)))
        err, rels = compare(torch, np, f"{name}{BF16} {route}", got, want,
                            keep, scales, tol=BF16_TOL[name])
        dist, rms, rms32 = 0.0, [], []
        for g, r, p_ in zip(got, ref, want):
            if g.dim() >= 3:
                diff, diff32 = (g - p_).abs(), (g - r).abs()
                if keep is not None and diff.shape == keep.shape:
                    diff, diff32 = diff[keep], diff32[keep]
                scale = float(p_.abs().max())
                dist = max(dist, float(diff32.max()) / scale)
                rms.append(float(diff.double().pow(2).mean().sqrt()) / scale)
                rms32.append(float(diff32.double().pow(2).mean().sqrt())
                             / scale)
        check(max(rms) <= BF16_RMS_TOL, f"{name}{BF16} {route}: root mean "
              f"square errors {rms} exceed {BF16_RMS_TOL}")
        check(dist > BF16_FROM_F32, f"{name}{BF16} {route}: within {dist} "
              f"of max of its float32 form: the bf16 path did not run")
        del got, want, ref
        work = bf16_work(name, rows, sht.n_theta, sht.n_phi, L, n_q=lead[1],
                         route=route)
        ms = cuda_ms(torch, lambda: kern(*args), 10)
        plain_ms = cuda_ms(torch, lambda: plain_fn(*args), 10)
        bound_ms, bound_by = bf16_bound(*work)
        r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, gflop_tensor_cores=work[0] / 1e9,
                 gflop_cuda_cores=work[1] / 1e9, mbytes=work[2] / 1e6)
        emit(phase="kernel", name=name + BF16, shapes=shapes, route=route,
             shape=list(args[0].shape), rel_errs=rels, max_abs_err=err,
             tol=BF16_TOL[name], rms_rel_errs=rms, rms_tol=BF16_RMS_TOL,
             rel_dist_from_float32=dist, rms_rel_dist_from_float32=rms32,
             points_left_out=None if keep is None
             else int(keep.numel() - keep.sum()), **r)
        results[name + BF16] = dict(r, max_abs_err=err, rel_err=max(rels))
    check(not any(fused.launches[k] == 0 for k in fused.launches)
          and not any(fi.launches[k] == 0 for k in fi.launches),
          "a bf16 form was not launched")
    return results


def phase_bf16_kernels(torch, np, shapes):
    """The bf16 forms (bf16_forms) at the kernel phase's shapes on the FFT
    route, then on the dense route's grid of phase_dense. → {name: result}
    of the FFT route's."""
    sht, fused, fi, rng, lead = kernel_fixture(torch, np, shapes)
    results = bf16_forms(torch, np, rng, sht, fi, lead, shapes, "fft")
    del sht, fused, fi
    dense, fi_dense, lead = dense_fixture(torch, np, rng, shapes)
    bf16_forms(torch, np, rng, dense, fi_dense, lead, shapes, "dense")
    return results


def phase_ns_kernels(torch, np, rng, shapes):
    """B7 and B8 over every bucket of one projection at NS_SHAPES[shapes],
    random full-rank inputs, the minimax schedule."""
    from xframe_tpu_torch.ops import _build, fused_projection as fp
    from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu_torch.projects.fxs.projections import crop_buckets
    b, n_q, L = NS_SHAPES[shapes]
    buckets = crop_buckets(L)
    sched = DEFAULT_SCHEDULE

    def cx(shape):
        return torch.as_tensor((rng.standard_normal(shape)
                                + 1j * rng.standard_normal(shape)).astype(
                                    np.complex64), device="cuda")

    def orthonormal(rows, cols, lead=()):
        """(lead, rows, cols) with orthonormal columns, or orthonormal rows
        where rows < cols."""
        if rows >= cols:
            return torch.linalg.qr(cx(lead + (rows, cols)))[0]
        return torch.linalg.qr(cx(lead + (cols, rows)))[0].mH

    def conditioned(lead, c):
        """Q1·diag(s)·Q2† with s in [0.2, 1]: condition number ≤ 5."""
        s = torch.as_tensor(rng.uniform(0.2, 1.0, lead + (1, c)),
                            dtype=torch.complex64, device="cuda")
        return (orthonormal(c, c, lead) * s) @ orthonormal(c, c, lead).mH

    # B = V†D²I with orthonormal V, D² in [0.5, 1] and I = V·R, R as above:
    # B is full rank and well conditioned where n_q ≥ c
    d2 = torch.linspace(0.5, 1.0, n_q, device="cuda")[:, None]
    mats, proj = [], []
    for (l_lo, l_hi, h) in buckets:
        g, c = l_hi - l_lo + 1, 2 * h + 1
        mats.append(conditioned((b, g), c))
        v = orthonormal(n_q, c, (g,))
        take = torch.as_tensor(rng.uniform(size=(g, n_q)) > 0.2,
                               dtype=torch.float32, device="cuda")
        proj.append(dict(pd=(v.mH * d2.T).contiguous(),
                         it=(v @ conditioned((b, g), c)).contiguous(), v=v,
                         take=take, l_lo=l_lo, h=h))

    def polar(fn, dtype=torch.complex64):
        return lambda: tuple(fn(m.to(dtype), 16, schedule=sched)
                             for m in mats)

    def project(fn, dtype=torch.complex64):
        return lambda: tuple(
            fn(x["pd"].to(dtype), x["it"].to(dtype), x["v"].to(dtype),
               x["take"], l_lo=x["l_lo"], h=x["h"], schedule=sched)
            for x in proj)

    cases = {
        "polar_unitary": (polar(fp.polar_unitary),
                          polar(fp.polar_unitary_newton_schulz),
                          polar(fp.polar_unitary_newton_schulz,
                                torch.complex128), True),
        "fused_projection_bucket": (
            project(fp.fused_projection_bucket),
            project(fp.fused_projection_bucket_plain),
            project(fp.fused_projection_bucket_plain, torch.complex128),
            False),
    }

    def distance(got, want, absolute):
        return [float((g - w).abs().max()) / (
            1.0 if absolute else float(w.abs().max()))
            for g, w in zip(got, want)]

    results = {}
    for name, (kern, plain, plain64, absolute) in cases.items():
        got, want, want64 = kern(), plain(), plain64()
        torch.cuda.synchronize()
        # the line is printed before the bound is checked, so that a
        # failing run still shows both distances to the float64 run
        err, rels = compare(torch, np, name, got, want, tol=float("inf"),
                            absolute=absolute)
        results[name] = dict(max_abs_err=err, rel_err=max(rels))
        results[name].update(time_case(
            torch, name, lambda: kern(), lambda: plain(), (),
            ns_work(name, buckets, b, n_q, len(sched), 0), shapes,
            dict(restarts=b, n_q=n_q, l_max=L,
                 buckets=[[lo, hi, 2 * h + 1] for lo, hi, h in buckets],
                 errs_per_bucket=rels, max_abs_err=err, tol=NS_TOL[name],
                 kernel_vs_float64=distance(got, want64, absolute),
                 plain_vs_float64=distance(want, want64, absolute))))
        check(max(rels) <= NS_TOL[name],
              f"{name}: errors {rels} exceed {NS_TOL[name]}")
    # B7 and B8 bucket by bucket: the time, the cluster shape the wrapper
    # launched (S blocks of G product groups, "SxG"), how many clusters of
    # each shape of that kernel the card holds at once, and the time at
    # every other shape the card holds; no bucket on a single SM
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = fp.schedule_rows(16, sched)

    def label(shape):
        return f"{shape[0]}x{shape[1]}"

    def polar_bucket(m, x):
        args = _build.kernel_input(m, torch.complex64).reshape(
            (-1,) + m.shape[-2:])
        w = torch.empty_like(args)
        return (lambda shape: fp.launch_polar(args, w, rows, shape),
                lambda: fp.polar_unitary(m, 16, schedule=sched))

    def project_bucket(m, x):
        args = [_build.kernel_input(x[k], torch.complex64)
                for k in ("pd", "it", "v")]
        take = _build.kernel_input(x["take"], torch.float32)
        out = torch.empty_like(args[1])
        return (lambda shape: fp.launch_bucket(*args, take, out, x["l_lo"],
                                               x["h"], rows, shape),
                lambda: fp.fused_projection_bucket(
                    x["pd"], x["it"], x["v"], x["take"], l_lo=x["l_lo"],
                    h=x["h"], schedule=sched))
    for name, bucket_calls in (("polar_unitary", polar_bucket),
                               ("fused_projection_bucket", project_bucket)):
        resident = fp.max_active_clusters(dev, name)
        for (l_lo, l_hi, h), m, x in zip(buckets, mats, proj):
            n_mat, c = b * (l_hi - l_lo + 1), 2 * h + 1
            shape = fp.launch_shape(n_mat, c, resident, n_sm)
            at_shape, call = bucket_calls(m, x)
            by_shape = {}
            for other, n in sorted(resident.items()):
                if n > 0 and other[0] * other[1] <= (-(-c // 64)) ** 2:
                    by_shape[label(other)] = cuda_ms(
                        torch, lambda: at_shape(other), 5)
            ms = cuda_ms(torch, call, 10)
            work = ns_work(name, [(l_lo, l_hi, h)], b, n_q, len(sched), 0)
            emit(phase="kernel_bucket", name=name, shapes=shapes, c=c,
                 matrices=n_mat, cluster=label(shape),
                 blocks=n_mat * shape[0],
                 resident_clusters={label(k): v
                                    for k, v in resident.items()},
                 ms=ms, ms_by_cluster=by_shape, bound_ms=bound(*work)[0],
                 gflop=work[0] / 1e9)
            check(n_mat * shape[0] > 1,
                  f"{name} bucket c = {c} runs on one SM")
    return results


# ------------------------------------------------------------------- slices
def tutorial_problem():
    """The tutorial problem on the card: make_demo_problem(128, 64, 256×512,
    Newton-Schulz with the minimax schedule, SHT kernels, the fused
    iteration)."""
    from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    return make_demo_problem(N_Q, L_MAX, n_theta=N_THETA, n_phi=N_PHI,
                             procrustes_method="newton_schulz",
                             ns_schedule=DEFAULT_SCHEDULE, fused_sht=True,
                             device="cuda")


def variant(p, **kw):
    """An MTIP on the parts of a demo problem: fused_pipeline=False for the
    stepwise iteration, k2_fwd / k1_abs2 for the fused variants."""
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    m = p.mtip
    return MTIP(p.ft, m.rc, m.real, m.sw,
                p.integrator.w_broadcast.cpu().numpy(), p.initial_support,
                enforce_initial_support_limit=m.enforce_limit,
                device=m.device, **kw)


def stepwise(p):
    """The stepwise MTIP on the parts of a demo problem."""
    return variant(p, fused_pipeline=False)


def tutorial_schedule(Segment, np, sigma):
    full = []
    for _ in range(5):
        full += [Segment("HIO", 60, betas=np.full(60, 0.5), ft_stab=True),
                 Segment("SW", sigma=sigma, threshold=0.1),
                 Segment("ER", 40, betas=np.zeros(40), ft_stab=True)]
    full += [Segment("SW", sigma=sigma, threshold=0.1),
             Segment("ER", 100, betas=np.zeros(100), ft_stab=True)]
    return full


def short_schedule(Segment, np, sigma):
    """HIO 60 + SW + ER 40, the variants' schedule."""
    return [Segment("HIO", 60, betas=np.full(60, 0.5), ft_stab=True),
            Segment("SW", sigma=sigma, threshold=0.1),
            Segment("ER", 40, betas=np.zeros(40), ft_stab=True)]


def counters():
    from xframe_tpu_torch.ops import fused_mtip, fused_projection, fused_sht
    return (fused_sht.METHODS + fused_sht.BF16_METHODS + fused_mtip.METHODS
            + fused_mtip.BF16_METHODS + fused_projection.METHODS)


def implied_launches(schedule, mtip, finalize=False, replayed=0):
    """Kernel launches implied for the initial guess plus `schedule` (plus
    MTIP.finalize, plus `replayed` fused iterations of replay best
    tracking). An FT is one analysis and one synthesis. A fused
    iteration runs the analysis of ρ, the Hankel-fused ψ synthesis and the
    |ψ|² analysis (or, with k1_abs2, the |ψ|²-fused synthesis), the
    projection with the ψ_p analysis (or, without k2_fwd, the projection
    and one more analysis), the fused update, and under the fused
    projection one B8 launch per bucket. A stepwise ft-stab iteration runs
    three syntheses (ψ, the round trip, ρ_p), two complex analyses, one
    real analysis and one real synthesis. A shrink-wrap runs an FT and an
    inverse FT, SW_center two more for the centering once it is enabled.
    finalize runs an FT, a real
    analysis, one B7 launch per bucket where the kernels' method applies
    (complex64, 2L+1 > 128) and a real synthesis."""
    rc = mtip.rc
    buckets = len(rc._k5) if rc.k5_active else 0
    # the SHT and fused-iteration counters of the FT's table dtype
    tag = getattr(mtip.ft.harmonic, "_tag", "")
    n = _Tagged(dict.fromkeys(counters(), 0), tag)
    n["forward"] = n["inverse"] = 2
    fused = replayed
    for seg in schedule:
        if seg.method in ("SW", "SW_center"):
            centered = seg.method == "SW_center" and mtip._r_cart is not None
            n["forward"] += 4 if centered else 2
            n["inverse"] += 4 if centered else 2
        elif seg.method in ("HIO", "ER", "RAAR") and mtip._fi is not None:
            fused += seg.n
        elif seg.method in ("HIO", "ER", "RAAR"):
            n["forward"] += 2 * seg.n
            n["inverse"] += (3 if seg.ft_stab else 2) * seg.n
            n["forward_real"] += seg.n
            n["inverse_real"] += seg.n
    if mtip._fi is not None:
        steps = ["forward", "synthesize_update"]
        steps += ["synthesize_abs2"] if mtip.k1_abs2 else \
            ["hankel_synthesize", "forward_real_abs2"]
        steps += ["inverse_real_project_fwd"] if mtip.k2_fwd else \
            ["inverse_real_project", "forward"]
        for k in steps:
            n[k] += fused
        n["fused_projection_bucket"] += buckets * fused
    if finalize:
        for k in ("forward", "inverse", "forward_real", "inverse_real"):
            n[k] += 1
        n["polar_unitary"] += buckets
    return dict(n)


class _Tagged(dict):
    """A dict of launch counts whose SHT and fused-iteration keys take the
    table dtype's suffix (FusedSHT._tag: "" or "_bf16")."""

    def __init__(self, counts, tag):
        super().__init__(counts)
        self.tag = tag

    def _key(self, k):
        return k if k in ("polar_unitary", "fused_projection_bucket") \
            else k + self.tag

    def __getitem__(self, k):
        return super().__getitem__(self._key(k))

    def __setitem__(self, k, v):
        super().__setitem__(self._key(k), v)


def record_anchors(mtip):
    """Wrap mtip.materialize_best so that each call first records the
    anchors' positions and lengths (restarts' numpy arrays), read before it
    materialises. → the list it fills."""
    seen = []
    inner = mtip.materialize_best

    def materialize_best(state):
        if state.anchor_start is not None:      # eager states have none
            seen.append((state.anchor_start.cpu().numpy(),
                         state.anchor_len.cpu().numpy()))
        return inner(state)
    mtip.materialize_best = materialize_best
    return seen


def replay_iterations(np, schedule, records):
    """Fused iterations that replaying the recorded anchors runs: at every
    replay step, one for each distinct (method, ft_stab, β) among the
    restarts still replaying, (method, ft_stab, β) read from the
    schedule."""
    table = [(seg.method, bool(seg.ft_stab), float(np.float32(b)))
             for seg in schedule if seg.method in ("HIO", "ER", "RAAR")
             for b in seg.betas]
    n = 0
    for starts, lens in records:
        for i in range(int(lens.max(initial=0))):
            n += len({table[a + i] for a, k in zip(starts, lens) if i < k})
    return n


def launch_counts(mtip):
    from xframe_tpu_torch.parallel import mesh
    return mesh.launch_counts(mtip)


def reset_launches(mtip):
    from xframe_tpu_torch.ops import fused_projection
    harmonic = getattr(mtip.ft, "harmonic", None)
    if hasattr(harmonic, "reset_launches"):
        harmonic.reset_launches()
    if mtip._fi is not None:
        mtip._fi.reset_launches()
    fused_projection.reset_launches()


def small_problem(device, l_max, **kw):
    from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    kw.setdefault("procrustes_method", "newton_schulz")
    return make_demo_problem(16, l_max, ns_schedule=DEFAULT_SCHEDULE,
                             fused_sht=True, device=device, **kw)


def phase_small(torch, np):
    """Phase 4: small slices on the card (kernels, cuBLAS) against the same
    problems on the CPU (plain versions), from the same starting densities:
    relative error-series difference < 1e-4 on the first iteration and
    < 0.05 overall (tests/test_transforms.py:565-586)."""
    from xframe_tpu_torch.projects.fxs.phasing import Segment

    cases = {  # path → (L, problem options, MTIP options, schedule lengths)
        "fused": (8, {}, None, (4, 2)),
        "stepwise": (8, {}, dict(fused_pipeline=False), (4, 2)),
        "k2_fwd": (8, {}, dict(k2_fwd=False), (4, 2)),
        "k1_abs2": (8, {}, dict(k1_abs2=True), (4, 2)),
        "k2_fwd+k1_abs2": (8, {}, dict(k2_fwd=False, k1_abs2=True), (4, 2)),
        "pallas": (64, dict(n_theta=65, n_phi=130,
                            procrustes_method="newton_schulz_pallas"),
                   None, (2, 1)),
    }
    for path, (l_max, pkw, mkw, (n_hio, n_er)) in cases.items():
        t0 = time.perf_counter()
        errs, rho0 = {}, None
        for device in ("cpu", "cuda"):
            p = small_problem(device, l_max, **pkw)
            if rho0 is None:
                rho0 = p.initial_density_batch(0, 2)
            mtip = p.mtip if mkw is None else variant(p, **mkw)
            check((mtip._fi is None) == (path == "stepwise"),
                  f"small {path} slice on {device} runs the wrong iteration")
            check(mtip.rc.k5_active == (path == "pallas"),
                  f"small {path} slice: fused projection on/off wrongly")
            schedule = [Segment("HIO", n_hio, betas=np.full(n_hio, 0.5),
                                ft_stab=True),
                        Segment("SW", sigma=mtip.sw.default_sigma,
                                threshold=0.1),
                        Segment("ER", n_er, betas=np.zeros(n_er),
                                ft_stab=True)]
            _, e = mtip.run_batch(rho0.to(device), schedule)
            errs[device] = e.cpu().numpy()
        ref = errs["cpu"]
        rel = np.abs(errs["cuda"] - ref) / (np.abs(ref) + 1e-9)
        emit(phase="small", path=path, l_max=l_max,
             seconds=time.perf_counter() - t0,
             rel_first=float(rel[:, 0].max()), rel_max=float(rel.max()),
             rel_by_iteration=rel.max(axis=(0, 2)).tolist())
        check(rel[:, 0].max() < 1e-4 and rel.max() < 0.05,
              f"small {path} slice on the card departs from the CPU run: "
              f"{rel.max()}")


def fingerprint(np, p, best):
    """B_l fingerprint of best_rho against the data, l = 0, 2, 4, q >= 4
    (tests/test_phasing.py:92-104), through the plain transforms so that it
    does not lean on the kernels it helps to judge."""
    from xframe_tpu_torch.projects.fxs import invariants as itools
    sht, hankel = p.ft.sht, p.ft.hankel
    psi = sht.inverse(hankel.forward(sht.forward(best)))
    coeff = sht.forward_real((psi * psi.conj()).real).cpu().numpy()
    out = []
    for r in range(best.shape[0]):
        bl_rec = itools.harmonic_coeff_to_deg2_invariants_3d(coeff[r])
        dev = {}
        for l in (0, 2, 4):
            ref = p.bl[l][4:, 4:]
            dev[l] = float(np.abs(bl_rec[l][4:, 4:] - ref).max()
                           / np.abs(ref).max())
        out.append(dev)
    return out


def run_slice(torch, np, p, mtip, path, schedule, restarts=N_RESTARTS,
              finalize=False, run=None, anchors=None):
    """One run, the initial guess from seed 0 and then `run` (default
    MTIP.run_batch on the schedule; a runner takes its place) and
    MTIP.finalize of the best densities, with its checks; the launch counts
    are set to 0 just before and read just after. anchors: record_anchors'
    list for a replay MTIP, whose replayed iterations join the implied
    counts. → (launch counts, errors (restarts, n_iter, 2), finalize's
    (ψ_p, W), s/iteration/restart, the final state)."""
    if run is None:
        def run(rho0):
            return mtip.run_batch(rho0, schedule)
    torch.cuda.synchronize()
    reset_launches(mtip)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rho0 = p.initial_density_batch(gen, restarts)
    state, errors = run(rho0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = None
    if finalize:
        t1 = time.perf_counter()
        out = mtip.finalize(state.best_rho)
        torch.cuda.synchronize()
        finalize_s = time.perf_counter() - t1
    launches = launch_counts(mtip)

    n_iter = sum(s.n for s in schedule if s.method != "SW")
    errs = errors.cpu().numpy()                 # (restarts, n_iter, 2)
    main = errs[:, :, 0]
    best = state.best_rho
    finite = bool(np.isfinite(errs).all()
                  and torch.isfinite(torch.view_as_real(best)).all())
    if out is not None:
        finite &= bool(torch.isfinite(torch.view_as_real(out[0])).all()
                       and torch.isfinite(torch.view_as_real(out[1])).all())
    replayed = 0 if anchors is None else replay_iterations(np, schedule,
                                                           anchors)
    implied = implied_launches(schedule, mtip, finalize, replayed)
    extra = {} if out is None else dict(finalize_seconds=finalize_s)
    if anchors is not None:
        extra.update(replayed_iterations=replayed,
                     anchor_len=[a[1].tolist() for a in anchors])
    emit(phase="slice", path=path, seconds=seconds, iterations=n_iter,
         restarts=restarts,
         s_per_iteration_per_restart=seconds / (n_iter * restarts),
         restarts_per_hour=restarts * 3600.0 / seconds,
         first_main_error=[float(v) for v in main[:, 0]],
         last_main_error=[float(v) for v in main[:, -1]],
         launches=launches, implied_launches=implied,
         bl_fingerprint_deviation=fingerprint(np, p, best), **extra)
    check(errs.shape == (restarts, n_iter, 2)
          and tuple(best.shape) == (restarts,) + tuple(p.ft.grid_shape),
          f"{path}: unexpected shapes {errs.shape}, {tuple(best.shape)}")
    check(finite, f"{path}: non-finite errors, density or finalize output")
    for r in range(restarts):
        check(main[r, -1] < 0.5 * main[r, :5].mean(),
              f"{path} restart {r}: final error {main[r, -1]} not below "
              f"half the first five's mean {main[r, :5].mean()}")
    check(launches == implied,
          f"{path}: launch counts {launches} differ from implied {implied}")
    return launches, errs, out, seconds / (n_iter * restarts), state


def phase_slice(torch, np):
    """Phases 5 to 11 at tutorial scale: MTIP.run_batch through the fused
    iteration, the stepwise one and the two fused variants, then replay
    best tracking through MultiStartRunner, checkpoint and resume, and the
    ground-truth fidelity, each run from the same seeded initial guess;
    then the reconstruct and the average worker on the problem's data.
    The tutorial problem is freed on return, before the production phase
    measures its peak memory."""
    from xframe_tpu_torch.projects.fxs.phasing import Segment

    t0 = time.perf_counter()
    p = tutorial_problem()
    check(p.mtip._fi is not None, "the demo problem does not run the fused "
          "iteration")
    torch.cuda.synchronize()
    emit(phase="problem", seconds=time.perf_counter() - t0)

    sigma = p.mtip.sw.default_sigma
    schedule = tutorial_schedule(Segment, np, sigma)
    launches, errs = {}, {}
    fused = run_slice(torch, np, p, p.mtip, "fused", schedule)
    launches["fused"], errs["fused"] = fused[0], fused[1]
    short = short_schedule(Segment, np, sigma)
    launches["stepwise"], errs["stepwise"] = run_slice(
        torch, np, p, stepwise(p), "stepwise", short)[:2]
    first = {k: e[:, 0] for k, e in errs.items()}
    rel = np.abs(first["fused"] - first["stepwise"]) \
        / np.abs(first["stepwise"])
    emit(phase="fused_vs_stepwise", rel_first_iteration=rel.tolist())
    check(rel.max() < 1e-4, f"fused and stepwise first-iteration errors "
          f"differ by {rel.max()}")

    for path, kw in (("k2_fwd", dict(k2_fwd=False)),
                     ("k1_abs2", dict(k1_abs2=True))):
        launches[path], e = run_slice(torch, np, p, variant(p, **kw), path,
                                      short)[:2]
        rel = np.abs(e[:, 0] - first["fused"]) / np.abs(first["fused"])
        emit(phase="variant_vs_fused", path=path,
             rel_first_iteration=rel.tolist())
        check(rel.max() < 1e-4, f"{path} and fused first-iteration errors "
              f"differ by {rel.max()}")

    launches["replay"], replay_state = phase_replay(
        torch, np, p, "replay", schedule, N_RESTARTS, fused)
    del fused
    phase_checkpoint(torch, np, p, short)
    phase_fidelity(torch, np, p, replay_state)
    del replay_state
    phase_workers(torch, np, p)
    return launches


def phase_replay(torch, np, p, path, schedule, restarts, eager):
    """Replay best tracking through MultiStartRunner from the seeded initial
    guess of the eager run `eager` (run_slice's result on p.mtip), held to
    it: the error series and best_err within REPLAY_TOL relative (the JAX
    package's bound for replay against eager, tests/test_replay_best.py:52-
    60; the same kernels on the same inputs, so 0 is expected), best_rho
    within REPLAY_TOL of max|eager best|, best_mask equal. The implied
    launch counts include the replayed iterations, counted from the anchors
    read before each materialisation. → (launch counts, state)."""
    from xframe_tpu_torch.parallel.mesh import MultiStartRunner
    mtip = variant(p, best_mode="replay")
    check(mtip.best_mode == "replay", f"{path}: replay resolved to "
          f"{mtip.best_mode}")
    anchors = record_anchors(mtip)
    counts, errs, _, per_iter, state = run_slice(
        torch, np, p, mtip, path, schedule, restarts,
        run=MultiStartRunner(mtip, schedule), anchors=anchors)
    # the wrapper refers to mtip, which holds it: without this cycle the
    # problem's tables are freed with the problem, before the production
    # phase measures its peak memory
    del mtip.materialize_best
    e_errs, e_per_iter, e_state = eager[1], eager[3], eager[4]
    err_diff = float(np.abs(errs - e_errs).max())
    err_rel = float((np.abs(errs - e_errs) / np.abs(e_errs)).max())
    best_err_diff = float((state.best_err - e_state.best_err).abs().max())
    scale = float(e_state.best_rho.abs().max())
    rho_diff = float((state.best_rho - e_state.best_rho).abs().max())
    masks_equal = bool(torch.equal(state.best_mask.expand_as(
        e_state.best_mask), e_state.best_mask))
    emit(phase="replay_vs_eager", path=path, restarts=restarts,
         s_per_iteration_per_restart={"replay": per_iter,
                                      "eager": e_per_iter},
         anchor_len=anchors[-1][1].tolist(),
         anchor_start=anchors[-1][0].tolist(), materialisations=len(anchors),
         max_abs_error_diff=err_diff, max_rel_error_diff=err_rel,
         best_err_diff=best_err_diff, best_rho_diff=rho_diff,
         best_rho_max=scale, best_mask_equal=masks_equal, tol=REPLAY_TOL)
    check(err_rel <= REPLAY_TOL, f"{path}: replay error series depart from "
          f"eager's by {err_rel}")
    check(best_err_diff <= REPLAY_TOL * float(e_state.best_err.abs().max()),
          f"{path}: replay best_err departs from eager's by {best_err_diff}")
    check(rho_diff <= REPLAY_TOL * scale, f"{path}: replayed best_rho "
          f"departs from eager's by {rho_diff} (max {scale})")
    check(masks_equal, f"{path}: replayed best_mask differs from eager's")
    return counts, state


def phase_checkpoint(torch, np, p, schedule):
    """Phase 8: CheckpointingRunner on the tutorial problem over `schedule`
    (two chunks), eager and replay: one chunk with a checkpoint under a
    temporary directory, then a fresh runner resumes; errors, best_err and
    best_rho equal (bitwise: the same code on the same inputs) those of an
    uninterrupted run of the runner. Prints the checkpoint's bytes and the
    seconds of one save and one load."""
    import os
    import tempfile
    from xframe_tpu_torch.parallel.mesh import CheckpointingRunner
    for mode in ("eager", "replay"):
        t0 = time.perf_counter()
        mtip = variant(p, best_mode=mode)
        gen = torch.Generator(device="cuda").manual_seed(0)
        rho0 = p.initial_density_batch(gen, N_RESTARTS)
        full, full_errs = CheckpointingRunner(mtip, schedule)(rho0,
                                                              resume=False)
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "checkpoint.npz")
            first = CheckpointingRunner(mtip, schedule, checkpoint_path=ck)
            state, errs = first(rho0, resume=False, max_chunks=1)
            nbytes = os.path.getsize(ck)
            t1 = time.perf_counter()
            first._save(state, [errs], 1)
            save_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            first._load()
            load_s = time.perf_counter() - t1
            resumed, res_errs = CheckpointingRunner(
                mtip, schedule, checkpoint_path=ck)(rho0, resume=True)
        same = dict(
            errors=bool(torch.equal(res_errs, full_errs)),
            best_err=bool(torch.equal(resumed.best_err, full.best_err)),
            best_rho=bool(torch.equal(resumed.best_rho, full.best_rho)))
        emit(phase="checkpoint", mode=mode, chunks=len(first.chunks),
             checkpoint_bytes=nbytes, save_seconds=save_s,
             load_seconds=load_s, equal_to_uninterrupted=same,
             max_error_diff=float((res_errs - full_errs).abs().max()),
             best_rho_diff=float((resumed.best_rho
                                  - full.best_rho).abs().max()),
             seconds=time.perf_counter() - t0)
        check(all(same.values()), f"checkpoint {mode}: the resumed run "
              f"differs from the uninterrupted one: {same}")


def phase_fidelity(torch, np, p, state):
    """Phase 9: the ground truth on the card. (a) tests/test_torch_fidelity.py's
    problem, make_demo_problem(32, 16), its schedule and its initial density
    (seed 7 of a CPU generator, drawn on the CPU), run on the card:
    align_to_ground_truth against the demo's truth > FIDELITY_MIN (the JAX
    package's bound, tests/test_phasing.py:125). (b) The tutorial restarts
    of `state`, ranked by rank_restarts, each aligned on the card (the
    aligner's B1 and B2 launches counted); the best also on the CPU through
    the plain transforms, the two correlations within ALIGN_CPU_TOL."""
    from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
    from xframe_tpu_torch.parallel.mesh import rank_restarts
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth
    from xframe_tpu_torch.projects.fxs.phasing import Segment

    t0 = time.perf_counter()
    small = make_demo_problem(32, 16, device="cuda")
    sigma = small.mtip.sw.default_sigma
    schedule = [Segment("HIO", 40, betas=np.full(40, 0.5), ft_stab=True),
                Segment("SW", sigma=sigma * 2, threshold=0.09),
                Segment("ER", 20, betas=np.zeros(20), ft_stab=True),
                Segment("SW", sigma=sigma, threshold=0.09),
                Segment("ER", 40, betas=np.zeros(40), ft_stab=True)]
    rho0 = make_demo_problem(32, 16, device="cpu").initial_density_batch(
        torch.Generator().manual_seed(7), 1).to("cuda")
    s_small, e_small = small.mtip.run_batch(rho0, schedule)
    main = e_small[0, :, 0].cpu().numpy()
    corr, _, _, info = align_to_ground_truth(
        s_small.best_rho[0], small.shapes, small.ft,
        small.integrator.w_broadcast)
    emit(phase="fidelity_small", n_q=32, l_max=16, correlation=corr,
         angles=info["angles"], inverted=info["inverted"],
         first_main_error=float(main[0]), last_main_error=float(main[-1]),
         bound=FIDELITY_MIN, seconds=time.perf_counter() - t0)
    check(np.isfinite(main).all() and main[-1] < 0.1 * main[:5].mean(),
          f"fidelity problem did not converge: {main[-1]}")
    check(corr > FIDELITY_MIN, f"ground-truth correlation {corr} at N_q=32, "
          f"L=16 on the card is not above {FIDELITY_MIN}")

    t0 = time.perf_counter()
    order, best_err = rank_restarts(state)
    w = p.integrator.w_broadcast
    harmonic = p.ft.harmonic
    for rank, r in enumerate(order):
        torch.cuda.synchronize()
        harmonic.reset_launches()
        corr, _, _, info = align_to_ground_truth(state.best_rho[r], p.shapes,
                                                 p.ft, w)
        torch.cuda.synchronize()
        aligner_launches = dict(harmonic.launches)
        emit(phase="fidelity_tutorial", rank=rank, restart=int(r),
             best_err=float(best_err[r]), correlation=corr,
             angles=info["angles"], inverted=info["inverted"],
             launches=aligner_launches)
        check(aligner_launches["forward"] > 0
              and aligner_launches["inverse"] > 0,
              f"the aligner did not launch B1 and B2: {aligner_launches}")
        if rank == 0:
            best_corr, best = corr, state.best_rho[r]
    cpu_ft = SphericalFourierTransform(
        N_Q, L_MAX, q_max=0.4 * N_Q / 32.0, mode="midpoint",
        reciprocity_coefficient=2.0, n_theta=N_THETA, n_phi=N_PHI,
        device="cpu")
    cpu_corr = align_to_ground_truth(best.cpu(), p.shapes, cpu_ft,
                                     w.cpu())[0]
    emit(phase="fidelity_tutorial_cpu", correlation_card=best_corr,
         correlation_cpu=cpu_corr, diff=abs(best_corr - cpu_corr),
         tol=ALIGN_CPU_TOL, seconds=time.perf_counter() - t0)
    check(abs(best_corr - cpu_corr) <= ALIGN_CPU_TOL,
          f"the card's and the CPU's alignments of the best tutorial "
          f"density give correlations {best_corr} and {cpu_corr}")


def worker_inputs(np, p, home):
    """An invariants archive of the demo problem `p` under `home` (its
    projection matrices, average intensity, q grid, max order, a
    wavelength) and the reconstruct overrides that put the worker's grid
    on the demo's: N_q, L, q_max, 256×512, particle_radius = the demo's
    support radius, WORKER_RESTARTS restarts in chunks of WORKER_BATCH
    from seed 0, and the tutorial schedule with its refinement's
    shrink-wrap centered (SW_center + ER 100, the refinement of
    tests/test_pipeline_integration.py)."""
    import os
    from xframe_tpu_torch.projects.fxs.store import save_npz
    path = os.path.join(home, "tutorial_invariants.npz")
    save_npz(path, {"data_radial_points": p.ft.qs, "max_order": L_MAX,
                    "data_projection_matrices":
                        {"I1I1": p.projection_matrices},
                    "average_intensity": p.average_intensity,
                    "xray_wavelength": 1.23984})
    return {"particle_radius": float(p.radius * 1.2),
            "grid": {"n_radial_points": N_Q, "max_order": L_MAX,
                     "max_q": float(p.ft.q_max), "n_theta": N_THETA,
                     "n_phi": N_PHI},
            "input": {"invariants_path": path},
            "main_loop": {"sub_loops": {"refinement": {
                "order": ["SW_center", "ER"],
                "methods": {"SW_center": {"iterations": 1},
                            "ER": {"iterations": 100}}}}},
            "multi_start": {"n_reconstructions": WORKER_RESTARTS,
                            "batch_size": WORKER_BATCH, "seed": 0},
            "IO": copy.deepcopy(NO_VTK["reconstruct"])}


def spy_worker(worker, chunks, seen):
    """Count each chunk's launches inside worker.run(): the counts are set
    to 0 as a chunk draws its initial densities and read when its runner
    returns; replay's anchors are read before each materialisation.
    `chunks` gets (counts, anchors) per chunk; `seen` gets the worker's
    mtip, ft, aux, initial-density function ("guess") and schedule, the
    restarts' rank order and the collection's launch counts. → a function
    that removes the spies (they refer to the MTIP that holds them)."""
    inner_setup, inner_collect = worker.setup_mtip, worker._collect_results

    def setup_mtip(inv):
        mtip, ft, aux = inner_setup(inv)
        guess, run_batch = aux["initial_density_batch"], mtip.run_batch
        anchors = record_anchors(mtip)

        def initial_density_batch(seed, n):
            reset_launches(mtip)
            seen["first_anchor"] = len(anchors)
            return guess(seed, n)

        def spy_run_batch(rho0, schedule):
            out = run_batch(rho0, schedule)
            chunks.append((launch_counts(mtip),
                           anchors[seen["first_anchor"]:]))
            seen["schedule"] = schedule
            return out
        aux["initial_density_batch"] = initial_density_batch
        mtip.run_batch = spy_run_batch
        seen.update(mtip=mtip, ft=ft, aux=aux, guess=guess)
        return mtip, ft, aux

    def collect_results(mtip, ft, aux, states, errors, order, *args, **kw):
        reset_launches(mtip)
        out = inner_collect(mtip, ft, aux, states, errors, order, *args,
                            **kw)
        seen.update(order=order, collect_counts=launch_counts(mtip))
        return out
    worker.setup_mtip = setup_mtip
    worker._collect_results = collect_results

    def remove():
        del worker.setup_mtip, worker._collect_results
        if "mtip" in seen:
            del seen["mtip"].run_batch, seen["mtip"].materialize_best
            seen["aux"]["initial_density_batch"] = seen["guess"]
    return remove


def phase_worker(torch, np, p, home):
    """Phase 10: the reconstruct worker on the card through select_worker +
    run, on its tutorial settings (replay, WORKER_RESTARTS restarts in
    chunks of WORKER_BATCH, the 600-iteration schedule) from an invariants
    archive of the tutorial problem `p`, the refinement's shrink-wrap
    centered (SW_center). Checks: (a) chunk 0 equals a MultiStartRunner run
    of the worker's MTIP and schedule from initial_density_batch(0,
    WORKER_BATCH) bitwise (errors, best_err, best_rho), and that run equals
    the eager twin of the MTIP bitwise (errors, best_err, best_rho, ρ,
    support: replay through SW_center); SW_center on the card against the
    CPU (phase_sw_center); (b) every chunk's launch counts equal the
    schedule's implied ones, replayed iterations included, and the
    collection's equal its finalize and deg-2 diagnostic; (c) every
    restart's final main error below half the mean of its first five;
    (d) the best restart's ground-truth correlation > BEST_MIN, all
    aligned in one batch (fidelity.align_batch_to_ground_truth,
    align_to_ground_truth's batch form). → the run number."""
    import os
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.parallel.mesh import MultiStartRunner
    from xframe_tpu_torch.projects.fxs.fidelity import \
        align_batch_to_ground_truth

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    overrides = worker_inputs(np, p, home)
    worker = select_worker("fxs", "reconstruct", "tutorial",
                           overrides=overrides, device="cuda")
    chunks, seen = [], {}
    remove_spies = spy_worker(worker, chunks, seen)
    t0 = time.perf_counter()
    res = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    remove_spies()
    mtip, schedule, aux = seen["mtip"], seen["schedule"], seen["aux"]
    collect_counts, order = seen["collect_counts"], seen["order"]
    path, run = worker.saved
    timing = res["timing"]
    results = res["reconstruction_results"]
    n_iter = sum(s.n for s in schedule if s.method in ("HIO", "ER", "RAAR"))
    walls = timing["chunk_walls_s"]
    steady = float(np.mean(walls[1:])) / (WORKER_BATCH * n_iter)
    densities = [k for k in ("real_density", "last_real_density",
                             "reciprocal_density", "initial_density")]
    density_bytes = sum(results[k][d].nbytes for k in results
                        for d in densities)
    emit(phase="worker", restarts=WORKER_RESTARTS, batch=WORKER_BATCH,
         iterations=n_iter, wall_seconds=wall, setup_s=timing["setup_s"],
         phasing_s=timing["phasing_s"], chunk_walls_s=walls,
         s_per_iteration_per_restart=timing["sec_per_iteration_per_restart"],
         steady_s_per_iteration_per_restart=steady,
         collect_s=timing["collect_s"], save_s=timing["save_s"],
         saved_bytes=os.path.getsize(path), density_bytes=density_bytes,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         best_tracking=mtip.best_mode, fused=mtip._fi is not None)
    check(mtip._fi is not None and mtip.best_mode == "replay",
          "the worker does not run the fused iteration with replay")
    check(mtip._r_cart is not None
          and any(s.method == "SW_center" for s in schedule),
          "the worker's schedule has no centered shrink-wrap")
    check(len(results) == WORKER_RESTARTS and len(chunks)
          == -(-WORKER_RESTARTS // WORKER_BATCH),
          f"worker: {len(results)} results from {len(chunks)} chunks")

    # (b) launches per chunk, and in the collection
    for ci, (counts, anchors) in enumerate(chunks):
        replayed = replay_iterations(np, schedule, anchors)
        implied = implied_launches(schedule, mtip, replayed=replayed)
        emit(phase="worker_chunk", chunk=ci, seconds=walls[ci],
             replayed_iterations=replayed,
             anchor_len=[a[1].tolist() for a in anchors], launches=counts,
             implied_launches=implied)
        check(counts == implied, f"worker chunk {ci}: launch counts "
              f"{counts} differ from implied {implied}")
    implied = dict.fromkeys(counters(), 0)
    implied.update(forward=2, inverse=2, forward_real=2, inverse_real=1)
    emit(phase="worker_collect", launches=collect_counts,
         implied_launches=implied)
    check(collect_counts == implied, f"worker collection: launch counts "
          f"{collect_counts} differ from implied {implied}")

    # (a) chunk 0 against the runner alone, and against the eager twin of
    # the worker's MTIP: replay gives eager's state through SW_center
    t0 = time.perf_counter()
    rho0 = aux["initial_density_batch"](0, WORKER_BATCH)
    state, errors = MultiStartRunner(mtip, schedule)(rho0)
    eager = copy.copy(mtip)
    eager.best_mode = "eager"
    e_state, e_errors = eager.run_batch(rho0, schedule)
    vs_eager = dict(
        errors=bool(torch.equal(errors, e_errors)),
        best_err=bool(torch.equal(state.best_err, e_state.best_err)),
        best_rho=bool(torch.equal(state.best_rho, e_state.best_rho)),
        rho=bool(torch.equal(state.rho, e_state.rho)),
        support=bool(torch.equal(state.support, e_state.support)))
    del e_state, e_errors
    emit(phase="worker_replay_vs_eager", chunk=0, equal=vs_eager,
         seconds=time.perf_counter() - t0)
    check(all(vs_eager.values()), f"worker chunk 0: replay departs from "
          f"eager through SW_center: {vs_eager}")
    # a density not yet centered: chunk 0 after the first HIO + SW + ER
    pre = eager.run_batch(rho0, schedule[:3])[0]
    del eager, rho0
    phase_sw_center(torch, mtip, schedule, pre, overrides)
    del pre
    t0 = time.perf_counter()
    errors = errors.cpu().numpy()
    best_err = state.best_err.cpu().numpy()
    best_rho = state.best_rho.cpu().numpy()
    sqrt_s = float(np.sqrt(aux["data_scale"]))
    same = {}
    for rank, r in enumerate(order):
        if r >= WORKER_BATCH:
            continue
        got = results[str(rank)]
        same[int(r)] = dict(
            main=bool(np.array_equal(got["error_dict"]["main"],
                                     errors[r, :, 0])),
            reciprocal=bool(np.array_equal(got["error_dict"]["reciprocal"],
                                           errors[r, :, 1])),
            best_err=got["error_dict"]["final"] == float(best_err[r]),
            best_rho=bool(np.array_equal(got["real_density"],
                                         best_rho[r] * sqrt_s)))
    del state, best_rho
    emit(phase="worker_vs_runner", chunk=0, restarts_equal=same,
         seconds=time.perf_counter() - t0)
    check(len(same) == WORKER_BATCH and all(
        all(v.values()) for v in same.values()),
        f"worker chunk 0 departs from the runner: {same}")

    # (c) convergence, (d) the ground truth, every restart in one batch
    t0 = time.perf_counter()
    ranks = [str(r) for r in range(len(results))]
    corrs, _, _, infos = align_batch_to_ground_truth(
        [results[r]["real_density"] for r in ranks], p.shapes, seen["ft"],
        p.integrator.w_broadcast)
    emit(phase="worker_fidelity", seconds=time.perf_counter() - t0,
         correlation=corrs, restart=[int(r) for r in order],
         inverted=[i["inverted"] for i in infos],
         best_err=[results[r]["error_dict"]["final"] for r in ranks],
         deg2_invariant_relative=results["0"]["error_dict"][
             "deg2_invariant_relative"].tolist(), bound=BEST_MIN)
    for r in ranks:
        main = results[r]["error_dict"]["main"]
        check(np.isfinite(main).all() and main[-1] < 0.5 * main[:5].mean(),
              f"worker rank {r}: final error {main[-1]} not below half "
              f"the first five's mean {main[:5].mean()}")
    check(corrs[0] > BEST_MIN, f"the worker's best restart correlates "
          f"{corrs[0]} with the truth, not above {BEST_MIN}")
    return run


def phase_sw_center(torch, mtip, schedule, state, overrides):
    """SW_center on the card against the plain transforms on the CPU: the
    worker's centered shrink-wrap of `state` through MTIP._shrink_wrap,
    and the same call of the worker's CPU set-up on the same state; the
    center of mass it removes and the largest change of each density,
    relative to its max, printed. Per restart the centered density within
    SW_CENTER_TOL of its max (the bound tests/test_torch_reconstruct.py
    holds the port to against the JAX package); the supports equal
    wherever the blurred density is not within 1e-4 of the threshold, at
    least 99% of the grid."""
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.projects.fxs.phasing import PhasingState
    t0 = time.perf_counter()
    seg = next(s for s in schedule if s.method == "SW_center")
    w = state.rho.abs() * mtip._w_err
    com = torch.einsum("...c,b...->bc", mtip._r_cart, w) \
        / w.sum(_GRID_DIMS)[:, None]
    del w
    card = mtip._shrink_wrap(state, seg)
    cpu_worker = select_worker("fxs", "reconstruct", "tutorial",
                               overrides=overrides, device="cpu")
    cpu_mtip = cpu_worker.setup_mtip(cpu_worker._load_invariants())[0]
    cpu_seg = next(s for s in cpu_worker._build_schedule(cpu_mtip.ft)
                   if s.method == "SW_center")
    plain = cpu_mtip._shrink_wrap(PhasingState(*[
        None if x is None else x.cpu() for x in state]), cpu_seg)
    got, want = card.rho.cpu(), plain.rho
    scale = want.abs().amax(_GRID_DIMS)
    moved = (got - state.rho.cpu()).abs().amax(_GRID_DIMS) / scale
    rho_diff = (got - want).abs().amax(_GRID_DIMS) / scale
    m = cpu_mtip
    blurred = m.ft.inverse(m.ft.forward(want.abs().to(torch.complex64))
                           * m.sw.gaussian_values(cpu_seg.sigma)).real
    c = torch.clamp(blurred, min=0.0)
    lo = c.amin(dim=_GRID_DIMS, keepdim=True)
    hi = c.amax(dim=_GRID_DIMS, keepdim=True)
    clear = ((c - lo) / (hi - lo) - cpu_seg.threshold).abs() > 1e-4
    sup_card = card.support.cpu().expand_as(clear)
    sup_cpu = plain.support.expand_as(clear)
    mismatched = int((sup_card != sup_cpu)[clear].sum())
    clear_share = float(clear.float().mean())
    emit(phase="sw_center_vs_cpu", sigma=seg.sigma, threshold=seg.threshold,
         center_of_mass=com.tolist(), rel_rho_diff=rho_diff.tolist(),
         rel_change=moved.tolist(),
         support_mismatched_clear=mismatched, clear_share=clear_share,
         support_voxels=int(sup_card.sum()), tol=SW_CENTER_TOL,
         seconds=time.perf_counter() - t0)
    check(float(rho_diff.max()) <= SW_CENTER_TOL,
          f"SW_center: the card's centered densities depart from the CPU's "
          f"by {rho_diff.tolist()} of their max")
    check(mismatched == 0 and clear_share > 0.99,
          f"SW_center: {mismatched} supports differ away from the "
          f"threshold ({clear_share} of the grid clear)")


def phase_average(torch, np, p, run):
    """Phase 11: the average worker on the card through select_worker +
    run, on its tutorial settings with PRTF, FSC and FQCB, over the worker
    phase's archive `run`: the averaged density's ground-truth correlation
    > AVERAGE_MIN; the aligned count, the PRTF resolution, the FSC and
    FQCB curves, the seconds of load, alignment, metrics and save, and B1
    and B2 launches per candidate printed."""
    import os
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    worker = select_worker(
        "fxs", "average", "tutorial",
        overrides={"reconstruction_files": [int(run)],
                   "resolution_metrics": {"PRTF": True, "FSC": True,
                                          "FQCB": True},
                   "IO": copy.deepcopy(NO_VTK["average"])},
        device="cuda")
    t0 = time.perf_counter()
    res = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(worker.ft.harmonic.launches)
    n_in = len(res["input"])
    metrics = res["resolution_metrics"]
    corr, _, _, info = align_to_ground_truth(res["average"]["real_density"],
                                             p.shapes, worker.ft,
                                             p.integrator.w_broadcast)
    emit(phase="average", candidates=n_in - 1, aligned=len(res["aligned"]),
         truth_seconds=time.perf_counter() - t0 - wall,
         wall_seconds=wall, **res["timing"],
         saved_bytes=os.path.getsize(worker.saved[0]),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches,
         launches_per_candidate={k: launches[k] / max(n_in - 1, 1)
                                 for k in ("forward", "inverse")},
         l2_to_ref=res["rotation_metric"]["l2_to_ref"].tolist(),
         inverted=res["rotation_metric"]["inverted"].tolist(),
         prtf_resolution_q=float(metrics["PRTF_resolution_q"]),
         prtf=metrics["PRTF"].tolist(), fsc=metrics["FSC"].tolist(),
         fqcb=metrics["FQCB_from_density"].tolist(), correlation=corr,
         correlation_inverted=info["inverted"], bound=AVERAGE_MIN)
    check(launches["forward"] > 0 and launches["inverse"] > 0,
          f"the average worker did not launch B1 and B2: {launches}")
    for name in ("PRTF", "FSC", "FQCB_from_density"):
        check(bool(np.isfinite(metrics[name]).all()),
              f"average: non-finite {name}")
    check(corr > AVERAGE_MIN, f"the averaged density correlates {corr} "
          f"with the truth, not above {AVERAGE_MIN}")


def phase_workers(torch, np, p):
    """Phases 10 and 11 in a temporary XFRAME_TPU_HOME, deleted after."""
    import os
    import tempfile
    old = os.environ.get("XFRAME_TPU_HOME")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as home:
        os.environ["XFRAME_TPU_HOME"] = home
        try:
            run = phase_worker(torch, np, p, home)
            phase_average(torch, np, p, run)
            phase_archives(torch, np, run, ARCHIVES_SEED)
            emit(phase="workers", seconds=time.perf_counter() - t0)
        finally:
            if old is None:
                os.environ.pop("XFRAME_TPU_HOME", None)
            else:
                os.environ["XFRAME_TPU_HOME"] = old


# ------------------------------------------------------------------ archives
# the archive rule on the card: HDF5 archives and PNG figures where h5py
# and matplotlib import, else .npz and one line naming each package; the
# SPB run folder, HDF5 only, at tests/test_spb.py's size (4 modules of
# 512×128 pixels, 20 frames) through PanelCorrelator, card against CPU at
# the panel phase's bound
SPB_MODULES, SPB_FRAMES, ARCHIVES_SEED = 4, 20, 0
SPB_CORRELATE = {"structure_name": "spb", "polar_grid": {"n_q": 24,
                                                         "n_phi": 64},
                 "batch_size": 8, "max_n_patterns": SPB_FRAMES,
                 "input": {"source": "experiment"}}
ARCHIVE_FIGURES = {"files": {"reconstructions": {"options": {
    "generate_vtk_files": False, "plot_error_metrics": True,
    "plot_first_used_invariants": True, "generate_2d_images": 2}}}}


def write_spb_run(np, folder, seed):
    """A synthetic SPB run folder: SPB_MODULES module files of SPB_FRAMES
    uniform [0, 10) frames from `seed` (h5py)."""
    import os
    import h5py
    rng = np.random.default_rng(seed)
    for mod in range(SPB_MODULES):
        with h5py.File(os.path.join(folder,
                                    f"RAW-R0001-AGIPD{mod:02d}-S00000.h5"),
                       "w") as f:
            f.create_dataset(
                f"INSTRUMENT/SPB_DET_AGIPD1M-1/DET/{mod}CH0:xtdf/image/data",
                data=rng.uniform(0, 10, (SPB_FRAMES, 512, 128)).astype(
                    np.float32))


def phase_archives(torch, np, run, seed):
    """Phase `archives`, after `average` in the workers' home: the worker
    phase's archive `run` read back through the format-agnostic
    ProjectStore.load, then saved again with the figures asked. Where
    h5py imports: the save is HDF5 and reads back equal to the same tree
    through .npz, and correlate's input.source experiment runs a synthetic
    SPB run folder through PanelCorrelator on the card, held against the
    CPU within PANEL_TOL of max; where it does not: the save is .npz with
    a line naming h5py, and input.source experiment stops naming h5py
    before any device work. Where matplotlib imports: the PNGs the save
    asks for exist and `view` draws; where it does not: the save's notice
    and `view`'s exit name matplotlib."""
    import contextlib
    import io
    import os
    import tempfile
    from xframe_tpu_torch.io import hdf5
    from xframe_tpu_torch.main import main as cli
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.projects.fxs import figures
    from xframe_tpu_torch.projects.fxs.store import (ProjectStore, flatten,
                                                     load_npz, save_npz)
    from xframe_tpu_torch.settings import load_settings
    t0 = time.perf_counter()
    h5, mpl = hdf5.available(), figures.available()
    settings = load_settings("reconstruct", "tutorial",
                             {"IO": ARCHIVE_FIGURES})
    store = ProjectStore(settings["structure_name"], settings)
    path, _ = store.path("reconstructions", run)
    data = store.load("reconstructions", path=path)
    checks = {"worker_archive": path.endswith(".h5" if h5 else ".npz")
              and len(data["reconstruction_results"]) == WORKER_RESTARTS}
    printed = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        saved, _ = store.save("reconstructions", data)
    save_s = time.perf_counter() - t1
    printed = printed.getvalue()
    folder = os.path.dirname(saved)
    pngs = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    asked = sorted(store._figures("reconstructions", data))
    checks["figures_asked"] = len(asked) == 4
    if mpl:
        checks["pngs"] = pngs == asked
    else:
        checks["figures_notice"] = not pngs and \
            f"figures not written ({', '.join(asked)}): matplotlib is not " \
            "installed" in printed
    line = dict(branch=f"h5py {'imports' if h5 else 'absent'}, "
                f"matplotlib {'imports' if mpl else 'absent'}",
                worker_archive=os.path.basename(path),
                saved=os.path.basename(saved),
                saved_bytes=os.path.getsize(saved), save_s=save_s,
                pngs=pngs)
    with tempfile.TemporaryDirectory() as tmp:
        if h5:
            npz = os.path.join(tmp, "data.npz")
            save_npz(npz, data)
            a = flatten(store.load("reconstructions", path=saved))
            b = flatten(load_npz(npz))
            checks["h5_equals_npz"] = saved.endswith(".h5") \
                and a.keys() == b.keys() \
                and all(np.array_equal(a[k], b[k]) for k in a)
        else:
            checks["h5py_notice"] = saved.endswith(".npz") and \
                "data.h5: h5py is not installed; wrote data.npz in its " \
                "place" in printed
        exit_msg = None
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli(["view", saved, "-o", tmp, "-n", "1"])
            stem = os.path.splitext(os.path.basename(saved))[0]
            viewed = rc == 0 and os.path.exists(
                os.path.join(tmp, f"{stem}_view_0.png"))
        except SystemExit as exc:
            viewed, exit_msg = False, str(exc.code)
        checks["view"] = viewed if mpl else \
            "matplotlib is not installed" in (exit_msg or "")
        line["view_exit"] = exit_msg
        spb = os.path.join(tmp, "spb_run")
        os.makedirs(spb)
        overrides = dict(SPB_CORRELATE, experiment={
            "run_folder": spb, "detector_distance": 0.2})
        if h5:
            write_spb_run(np, spb, seed)
            out = {}
            for dev in ("cuda", "cpu"):
                t1 = time.perf_counter()
                w = select_worker("fxs", "correlate", "tutorial",
                                  overrides=overrides, device=dev)
                with contextlib.redirect_stdout(io.StringIO()):
                    out[dev] = w.run()
                line[f"spb_{dev}_s"] = time.perf_counter() - t1
            card, cpu = (out[d]["cross_correlation"]["I1I1"]
                         for d in ("cuda", "cpu"))
            err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
            checks["spb_vs_cpu"] = err <= PANEL_TOL and bool(
                np.isfinite(card).all())
            checks["spb_good"] = out["cuda"]["num_images_good"] \
                == out["cpu"]["num_images_good"] == SPB_FRAMES
            line.update(spb_cpu_vs_card=err, tol=PANEL_TOL,
                        spb_timing=out["cuda"]["timing"])
        else:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            w = select_worker("fxs", "correlate", "tutorial",
                              overrides=overrides, device="cuda")
            stop = None
            try:
                w.run()
            except ImportError as exc:
                stop = str(exc)
            checks["spb_stops_naming_h5py"] = "h5py" in (stop or "") \
                and torch.cuda.memory_allocated() == before \
                and not os.path.exists(w.store.folder("ccd"))
            line["spb_stop"] = stop
    emit(phase="archives", checks=checks,
         seconds=time.perf_counter() - t0, **line)
    check(all(checks.values()), f"archives: checks failed: "
          f"{[k for k, v in checks.items() if not v]}")


# ------------------------------------------------------------------ chain
def kernel_instances(counts):
    """Register every FusedSHT and FusedIteration built while the returned
    context is open; on exit `counts` gets the sum of their launch counts
    (each instance starts at 0, so these are the launches of what ran
    inside) and fused_projection's module counts, set to 0 on entry."""
    import contextlib
    from xframe_tpu_torch.ops import fused_projection
    from xframe_tpu_torch.ops.fused_mtip import FusedIteration
    from xframe_tpu_torch.ops.fused_sht import FusedSHT

    @contextlib.contextmanager
    def registered():
        made, inits = [], {}
        for cls in (FusedSHT, FusedIteration):
            inits[cls] = cls.__init__

            def init(self, *a, _inner=cls.__init__, **kw):
                _inner(self, *a, **kw)
                made.append(self)
            cls.__init__ = init
        fused_projection.reset_launches()
        try:
            yield
        finally:
            for cls, inner in inits.items():
                cls.__init__ = inner
            counts.update(dict.fromkeys(counters(), 0))
            for obj in made:
                for k, v in obj.launches.items():
                    counts[k] += v
            for k, v in fused_projection.launches.items():
                counts[k] += v
    return registered()


def spy_simulate(module, seen):
    """Keep the simulate worker's FT, density, intensity coefficients and
    B_l as they pass through `module` (projects/fxs/simulate_ccd). → a
    function that removes the spies."""
    inner_ic, inner_bl = module.intensity_coefficients, module.bl_from_coeff

    def intensity_coefficients(ft, density):
        seen.update(ft=ft, density=density)
        seen["coeff"] = inner_ic(ft, density)
        return seen["coeff"]

    def bl_from_coeff(coeff, n_particles):
        seen["bl"] = inner_bl(coeff, n_particles)
        return seen["bl"]
    module.intensity_coefficients = intensity_coefficients
    module.bl_from_coeff = bl_from_coeff

    def remove():
        module.intensity_coefficients = inner_ic
        module.bl_from_coeff = inner_bl
    return remove


def run_stage(torch, worker_name, settings_name, overrides=None,
              device="cuda", seen=None, **mesh_kw):
    """One worker through select_worker + run on `device`, its kernel
    launches counted (this process's: a mesh's other ranks report theirs in
    worker.rank_launches); `seen` gets the reconstruct worker's (mtip, ft,
    aux) as its set-up returns them; mesh_kw (`devices`) to select_worker.
    → (worker, results, launches, wall seconds, peak device memory)."""
    from xframe_tpu_torch.main import select_worker
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counts = {}
    t0 = time.perf_counter()
    with kernel_instances(counts):
        worker = select_worker("fxs", worker_name, settings_name,
                               overrides=overrides, device=device, **mesh_kw)
        if seen is not None:
            inner = worker.setup_mtip

            def setup_mtip(inv):
                seen["mtip"], seen["ft"], seen["aux"] = inner(inv)
                return seen["mtip"], seen["ft"], seen["aux"]
            worker.setup_mtip = setup_mtip
        res = worker.run()
        if device == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    return worker, res, counts, wall, peak


def stage_line(name, worker, res, counts, wall, peak, **extra):
    import os
    emit(phase="chain", stage=name, wall_seconds=wall,
         timing=res.get("timing"), saved_bytes=os.path.getsize(
             worker.saved[0]), max_memory_allocated=peak,
         launches={k: v for k, v in counts.items() if v}, **extra)


def check_simulate(torch, np, seen, res, counts):
    """The simulate stage: one launch each of B1, B2 and B3; the CC finite
    and exactly q1↔q2 symmetric; the card's density against build_density_from_shapes
    on a strided sub-grid (disagreement share below 5e-3, the JAX
    package's bound); the kernels' intensity coefficients within REL_TOL
    of max of the plain versions on the card on the same density."""
    from xframe_tpu_torch.library.shapes import spherical_grid
    from xframe_tpu_torch.projects.fxs.simulate_ccd import \
        build_density_from_shapes
    from xframe_tpu_torch.settings import load_settings
    implied = dict.fromkeys(counters(), 0)
    implied.update(forward=1, inverse=1, forward_real_abs2=1)
    check(counts == implied, f"simulate: launch counts {counts} differ "
          f"from implied {implied}")
    cc = res["cross_correlation"]["I1I1"]
    check(bool(np.isfinite(cc).all()), "simulate: non-finite CC")
    check(bool(np.array_equal(cc, np.swapaxes(cc, 0, 1))),
          "simulate: the CC is not exactly q1<->q2 symmetric")
    ft, density = seen["ft"], seen["density"]
    s = 8
    axes = (ft.rs[::s], ft.sht.theta[::s], ft.sht.phi[::s])
    host = build_density_from_shapes(
        spherical_grid(*axes),
        load_settings("simulate_ccd", "tutorial")["shapes"])
    card = density[::s, ::s, ::s].cpu().numpy()
    disagree = float((np.abs(card - host) > 1e-6).mean())
    sht, hankel = ft.sht, ft.hankel
    psi = sht.inverse(hankel.forward(sht.forward(
        density.to(torch.complex64))))
    plain = sht.forward_real_abs2(psi)
    del psi
    err, rels = compare(torch, np, "simulate intensity coefficients",
                        (seen["coeff"],), (plain,))
    emit(phase="chain_simulate_checks", density_points=int(host.size),
         density_disagreement=disagree, density_nonzero=int((host > 0).sum()),
         coeff_max_abs_err=err, coeff_rel_err=rels[0], tol=REL_TOL,
         cc_shape=list(cc.shape), cc_bytes=int(cc.nbytes))
    check(disagree < 5e-3, f"simulate: the card's density disagrees with "
          f"build_density_from_shapes on {disagree} of the sub-grid")


def check_extract(torch, np, res, bl_sim):
    """The extract stage: B_l finite, the odd orders zero, every even
    order PSD (least eigenvalue ≥ −1e-6 of the largest); the relative
    difference of each even order to the simulate stage's B_l printed."""
    bl = torch.as_tensor(res["deg_2_invariant"]["I1I1"], device="cuda")
    check(bool(torch.isfinite(torch.view_as_real(bl)).all()),
          "extract: non-finite B_l")
    check(float(bl[1::2].abs().max()) <= 1e-8 * float(bl.abs().max()),
          "extract: odd orders not 0")
    least, diffs = [], []
    for l in range(0, bl.shape[0], 2):
        sym = (bl[l] + bl[l].conj().T) / 2
        lam = torch.linalg.eigvalsh(sym)
        least.append(float(lam.min() / max(float(lam.max()), 1e-300)))
        ref = bl_sim[l].double()
        diffs.append(float((bl[l].real - ref).abs().max()
                           / ref.abs().max()))
    emit(phase="chain_extract_checks", orders=int(bl.shape[0]),
         least_eigenvalue_ratio=min(least),
         rel_diff_to_simulated_bl=diffs)
    check(min(least) >= -1e-6, f"extract: an even order is not PSD "
          f"({min(least)})")


def truth_correlations(torch, np, rec, avg_worker, avg, shapes):
    """Ground-truth correlations of the average and of every restart on the
    reconstruct grid, through the average worker's FT on the card."""
    from xframe_tpu_torch.ops.integrate import SphericalIntegrator
    from xframe_tpu_torch.projects.fxs.fidelity import (
        align_batch_to_ground_truth, align_to_ground_truth)
    ft = avg_worker.ft
    w = SphericalIntegrator(ft.rs, ft.sht.n_theta, ft.sht.n_phi,
                            device="cuda").w_broadcast
    corr = align_to_ground_truth(avg["average"]["real_density"], shapes, ft,
                                 w)[0]
    results = rec["reconstruction_results"]
    corrs = align_batch_to_ground_truth(
        [results[str(r)]["real_density"] for r in range(len(results))],
        shapes, ft, w)[0]
    return corr, corrs


def phase_chain_tutorial(torch, np):
    """The tutorial chain as a user runs it: simulate_ccd, extract,
    reconstruct and average on their shipped tutorial settings through
    select_worker + run, the reconstruct stage cut in depth to the mesh
    phase's one-card reference (MESH_REFERENCE). → (its launch counts, the
    simulate_ccd archive's path, the invariants archive's path, the
    reconstruct stage: results, archive, set-up, timing)."""
    from xframe_tpu_torch.projects.fxs import simulate_ccd
    from xframe_tpu_torch.settings import load_settings
    total = dict.fromkeys(counters(), 0)
    seen = {}
    remove = spy_simulate(simulate_ccd, seen)
    try:
        w, res, counts, wall, peak = run_stage(torch, "simulate_ccd",
                                               "tutorial")
    finally:
        remove()
    stage_line("simulate_ccd", w, res, counts, wall, peak,
               grid=list(seen["ft"].grid_shape), l_max=seen["ft"].sht.l_max,
               routes=[seen["ft"].harmonic.analysis_route,
                       seen["ft"].harmonic.synthesis_route])
    check_simulate(torch, np, seen, res, counts)
    ccd_path = w.saved[0]
    bl_sim = seen["bl"]
    seen.clear()
    del res
    for k in total:
        total[k] += counts[k]

    w, res, counts, wall, peak = run_stage(torch, "extract", "tutorial")
    stage_line("extract", w, res, counts, wall, peak)
    inv_path = w.saved[0]
    for k in total:
        total[k] += counts[k]
    check_extract(torch, np, res, bl_sim)
    del res, bl_sim

    seen = {}
    w, rec, counts, wall, peak = run_stage(torch, "reconstruct", "tutorial",
                                           MESH_REFERENCE, seen=seen)
    ref = SimpleNamespace(rec=rec, saved=w.saved[0], counts=counts,
                          timing=rec["timing"], rec_settings=w.settings,
                          **seen)
    stage_line("reconstruct", w, rec, counts, wall, peak)
    for k in total:
        total[k] += counts[k]
    for r, v in rec["reconstruction_results"].items():
        check(bool(np.isfinite(v["real_density"]).all()
                   and np.isfinite(v["error_dict"]["main"]).all()),
              f"reconstruct: restart {r} is not finite")

    w, avg, counts, wall, peak = run_stage(torch, "average", "tutorial")
    stage_line("average", w, avg, counts, wall, peak,
               aligned=len(avg["aligned"]))
    for k in total:
        total[k] += counts[k]
    t0 = time.perf_counter()
    shapes = load_settings("simulate_ccd", "tutorial")["shapes"]
    corr, corrs = truth_correlations(torch, np, rec, w, avg, shapes)
    emit(phase="chain_fidelity", average_correlation=corr,
         restart_correlations=corrs, best_correlation=corrs[0],
         bound=CHAIN_MIN, seconds=time.perf_counter() - t0)
    check(corr >= CHAIN_MIN, f"the tutorial chain's average correlates "
          f"{corr} with the truth, below {CHAIN_MIN}")
    ref.shapes, ref.inv_path = shapes, inv_path
    return total, ccd_path, inv_path, ref


def phase_chain_small(torch, np, home):
    """The chain at tests/test_pipeline_integration.py's sizes and
    overrides on the card, and extract on the CPU through the plain
    versions from the card's CC: V_l V_l† within CHAIN_CPU_TOL of max; the
    average above AVERAGE_MIN and the best restart above BEST_MIN."""
    import os
    ccd_ov = {"structure_name": "pipeline", "dimensions": 3,
              "grid": {"n_radial_points": 48, "max_order": 14, "max_q": 0.5},
              "shapes": PIPELINE_SHAPES,
              "cross_correlation": {"method": "back_substitution",
                                    "xray_wavelength": 1.23984}}
    ex_ov = {"structure_name": "pipeline", "dimensions": 3, "max_order": 14}
    t0 = time.perf_counter()
    sim = run_stage(torch, "simulate_ccd", None, ccd_ov)
    card = run_stage(torch, "extract", None, ex_ov)[1]
    cpu = run_stage(torch, "extract", None, dict(
        ex_ov, input={"ccd_path": sim[0].saved[0]}), device="cpu")[1]
    diff = max(float(np.abs(a @ a.conj().T - b @ b.conj().T).max()
                     / max(np.abs(b @ b.conj().T).max(), 1e-300))
               for a, b in zip(cpu["data_projection_matrices"]["I1I1"],
                               card["data_projection_matrices"]["I1I1"]))
    rec_ov = {
        "structure_name": "pipeline", "dimensions": 3, "particle_radius": 50,
        "grid": {"n_radial_points": 24, "max_order": 10},
        "multi_start": {"n_reconstructions": 3, "seed": 7},
        "main_loop": {"sub_loops": {
            "order": ["main", "refinement"],
            "main": {"iterations": 2, "order": ["HIO", "SW", "ER"],
                     "methods": {"HIO": {"iterations": 15},
                                 "SW": {"iterations": 1},
                                 "ER": {"iterations": 10}}},
            "refinement": {"iterations": 1, "order": ["SW_center", "ER"],
                           "methods": {"SW_center": {"iterations": 1},
                                       "ER": {"iterations": 15}}}}},
        "projections": {"real": {
            "shrink_wrap": {"sigmas": [False, False],
                            "thresholds": [0.09, 0.09]},
            "HIO": {"beta": [[0.5, 0.4, -1 / 50, 100],
                             [0.01, 0.002, -1 / 50, 50]]}}}}
    rec = run_stage(torch, "reconstruct", None, rec_ov)[1]
    avg_worker, avg = run_stage(torch, "average", None, {
        "structure_name": "pipeline",
        "selection": {"method": "least_error", "error_limit": 1.0,
                      "n_reconstructions": "all"},
        "l2_error_limit": 2.0,
        "resolution_metrics": {"PRTF": True, "FSC": True, "FQCB": True}})[:2]
    corr, corrs = truth_correlations(torch, np, rec, avg_worker, avg,
                                     PIPELINE_SHAPES)
    emit(phase="chain_small", cpu_vs_card_gram=diff, tol=CHAIN_CPU_TOL,
         average_correlation=corr, best_correlation=corrs[0],
         restart_correlations=corrs, ccd_bytes=os.path.getsize(
             sim[0].saved[0]), seconds=time.perf_counter() - t0)
    check(diff <= CHAIN_CPU_TOL, f"small chain: the CPU's V_l V_l† depart "
          f"from the card's by {diff} of max")
    check(corr > AVERAGE_MIN and corrs[0] > BEST_MIN,
          f"small chain: correlations {corr} (average), {corrs[0]} (best)")


def temporary_home():
    """A context: XFRAME_TPU_HOME set to a new temporary directory, deleted
    after, the old value restored. → the directory."""
    import contextlib
    import os
    import tempfile

    @contextlib.contextmanager
    def home():
        old = os.environ.get("XFRAME_TPU_HOME")
        with tempfile.TemporaryDirectory() as path:
            os.environ["XFRAME_TPU_HOME"] = path
            try:
                yield path
            finally:
                if old is None:
                    os.environ.pop("XFRAME_TPU_HOME", None)
                else:
                    os.environ["XFRAME_TPU_HOME"] = old
    return home()


def phase_chain(torch, np):
    """Phase 12: the tutorial chain, extract's options for experimental
    data on its simulate_ccd archive, then the small chain, then phase
    `options` (the reconstruct options on the chain's invariants) and
    phase `precision`'s runs (i), (ii) and (v), in a temporary
    XFRAME_TPU_HOME deleted after. → {"chain": the tutorial chain's launch
    counts, "extract_options": those of extract's options' run, "options":
    those of the reconstruct options' runs, "precision": those of
    precision's runs}."""
    t0 = time.perf_counter()
    with temporary_home() as home:
        counts, ccd_path, inv_path, ref = phase_chain_tutorial(torch, np)
        t0_mesh = time.perf_counter()
        mesh = phase_mesh(torch, np, ref)
        t0 += time.perf_counter() - t0_mesh      # chain_total leaves it out
        del ref
        options = phase_extract_options(torch, np, ccd_path)
        phase_chain_small(torch, np, home)
        emit(phase="chain_total", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        rec_options = phase_options(torch, np, inv_path)
        emit(phase="options_total", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        bf16 = phase_bf16(torch, np, inv_path)
        emit(phase="bf16_total", seconds=time.perf_counter() - t0)
        precision = phase_precision(torch, np, inv_path, ccd_path)
    return {"chain": counts, "extract_options": options,
            "options": rec_options, "precision": precision, "mesh": mesh,
            **bf16}


# ------------------------------------------------------------------ mesh
# the device mesh on one card: two ranks share cuda:0, so their times
# measure correctness, not scaling. The chain's reconstruct stage (the
# tutorial settings cut to MESH_RESTARTS restarts in one batch from seed 0)
# is the one-card reference of run (i); runs (ii), (iii) and (vi) take one
# cycle of the tutorial schedule (HIO 60 + SW + ER 40: two chunks)
MESH_RESTARTS, MESH_DEVICES = 4, ["cuda:0", "cuda:0"]
MESH_REFERENCE = {"multi_start": {"n_reconstructions": MESH_RESTARTS,
                                  "batch_size": 0, "seed": 0}}
MESH_ONE_CYCLE = {"main_loop": {"sub_loops": {"order": ["main"],
                                              "main": {"iterations": 1}}},
                  "IO": NO_VTK["reconstruct"]}
MESH_PRODUCTION_HIO = 20     # run (v): HIO 20 + SW, one chunk
MESH_FIRST_TOL = 1e-4         # the first iteration against the one-card batch
MESH_AVERAGE_TOL = 1e-6       # 2 ranks against 1, of max
MESH_NOTE = ("two ranks share one card: times measure correctness, not "
             "scaling")


def mesh_line(smi, **kw):
    emit(phase="mesh", card=smi, **kw)


def mesh_overrides(*parts, **extra):
    from xframe_tpu_torch.settings import deep_update
    out = {}
    for part in parts + (extra,):
        out = deep_update(out, copy.deepcopy(part))
    return out


def match_restarts(np, results, rho0, sqrt_s, what):
    """The ρ0 row each ranked result of an archive started from (its
    initial density equal bitwise to the row times √data_scale); fails
    unless every row is matched once. → [row of rank 0, …]."""
    rows = []
    for k in range(len(results)):
        init = results[str(k)]["initial_density"]
        hit = [i for i in range(len(rho0))
               if np.array_equal(init, rho0[i] * sqrt_s)]
        check(len(hit) > 0, f"mesh {what}: restart {k}'s initial density "
              "is no row of the one-card batch")
        rows.append(hit[0])
    check(sorted(rows) == list(range(len(rho0))),
          f"mesh {what}: the initial densities {rows} are not the one-card "
          "batch's rows")
    return rows


def rank_rows_bitwise(torch, np, res, rows, mtip, schedule, rho0, n_ranks,
                      what):
    """Each rank's restarts bitwise a one-card MultiStartRunner run of its
    rows of the wrap-padded batch: the archive's main and reciprocal error
    series and final error. → the one-card runs' seconds."""
    from xframe_tpu_torch.parallel.mesh import Mesh, MultiStartRunner
    results, t0 = res["reconstruction_results"], time.perf_counter()
    n = len(rho0)
    runs = {}
    for r in range(n_ranks):
        mine = Mesh(["cuda:0"] * n_ranks, ("restarts",), rank=r).rows(n)
        state, errs = MultiStartRunner(mtip, schedule)(rho0[torch.as_tensor(
            mine, device=rho0.device)])
        errs, best = errs.cpu().numpy(), state.best_err.cpu().numpy()
        for j, i in enumerate(mine):
            runs.setdefault(int(i), (errs[j], best[j]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for k, i in enumerate(rows):
        got, (errs, best) = results[str(k)], runs[i]
        same = (np.array_equal(got["error_dict"]["main"], errs[:, 0])
                and np.array_equal(got["error_dict"]["reciprocal"],
                                   errs[:, 1])
                and got["error_dict"]["final"] == float(best))
        check(same, f"mesh {what}: restart {i} differs from the one-card "
              "run of its rank's rows")
    return seconds


def archive_layout(np, tree, prefix=""):
    """{key path: (dtype, shape)} of an archive's arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(archive_layout(np, v, f"{prefix}{k}/"))
        elif isinstance(v, np.ndarray):
            out[prefix + k] = (str(v.dtype), v.shape)
    return out


def mesh_worker(torch, overrides, devices=MESH_DEVICES):
    """The reconstruct worker on its tutorial settings and `overrides`
    over a mesh of `devices` (its own spawned ranks). → (worker, results,
    wall seconds)."""
    from xframe_tpu_torch.main import select_worker
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = select_worker("fxs", "reconstruct", "tutorial", overrides=overrides,
                      device="cuda", devices=devices)
    res = w.run()
    torch.cuda.synchronize()
    return w, res, time.perf_counter() - t0


def add_counts(total, counts_list):
    for counts in counts_list or ():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v


def mesh_checkpoint_rank(mesh, overrides, paths, avg_overrides):
    """Phase mesh (iii) and (iv) on one rank (a module-level function: the
    spawned rank imports it): the worker's MTIP on the rank's device; the
    one-cycle schedule uninterrupted, then one chunk with a checkpoint
    (rank 0 copies it to paths["one_chunk"]), then resumed by a fresh
    runner; then the average worker on the rank's mesh. → on rank 0
    ({"full"|"resumed": (state arrays, errors)}, the exchanges, every
    rank's launch counts, the average's results and seconds)."""
    import shutil
    from xframe_tpu_torch.convert import state_arrays
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.parallel.mesh import CheckpointingRunner
    w = select_worker("fxs", "reconstruct", "tutorial", overrides=overrides,
                      device=mesh.device, mesh=mesh)
    mtip, ft, aux = w.setup_mtip(w._load_invariants())
    schedule = w._build_schedule(ft)
    rho0 = aux["initial_density_batch"](2, 2)
    full = CheckpointingRunner(mtip, schedule, mesh=mesh)(rho0, resume=False)
    CheckpointingRunner(mtip, schedule, checkpoint_path=paths["ck"],
                        mesh=mesh)(rho0, resume=False, max_chunks=1)
    if mesh.rank == 0:
        shutil.copy(paths["ck"], paths["one_chunk"])
    runner = CheckpointingRunner(mtip, schedule, checkpoint_path=paths["ck"],
                                 mesh=mesh)
    resumed = runner(rho0)
    exchanges = {k: dict(v) for k, v in mesh.exchanges.items()}
    t0 = time.perf_counter()
    avg = select_worker("fxs", "average", "tutorial",
                        overrides=avg_overrides, device=mesh.device,
                        mesh=mesh).run()
    if mesh.rank != 0:
        return None
    return ({k: (state_arrays(st), e.cpu().numpy())
             for k, (st, e) in (("full", full), ("resumed", resumed))},
            exchanges, runner.rank_launches, avg, time.perf_counter() - t0)


def start_mesh_cli(home, settings, devices=("cuda:0", "cuda:0")):
    """Start `python -m xframe_tpu_torch --distributed fxs reconstruct
    <settings>` as len(devices) processes with torchrun's variables
    (LOCAL_RANK the card's index: both 0 for two ranks on cuda:0). → a
    function that waits for them and checks them: → seconds. Should this
    script end before, the processes are stopped at its exit."""
    import atexit
    import os
    from xframe_tpu_torch.parallel.mesh import _free_port
    port, t0 = _free_port(), time.perf_counter()
    procs = []
    for r, dev in enumerate(devices):
        env = dict(os.environ, XFRAME_TPU_HOME=home, RANK=str(r),
                   WORLD_SIZE=str(len(devices)), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   LOCAL_RANK=str(int(dev.split(":")[1])))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "xframe_tpu_torch", "--distributed", "fxs",
             "reconstruct", settings], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__))))

    def stop():
        for p in procs:
            if p.poll() is None:
                p.kill()
    atexit.register(stop)

    def finish():
        outs = [p.communicate(timeout=600) for p in procs]
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"--distributed rank {r} exited "
                  f"{p.returncode}: {err[-3000:]}")
        check("saved to" in outs[0][0] and "saved to" not in outs[1][0],
              "--distributed: rank 0 alone should write the archive")
        return time.perf_counter() - t0
    return finish


def phase_mesh(torch, np, ref):
    """Phase mesh, on the tutorial chain's invariants (the chain's home):
    (i) the reconstruct worker on its tutorial settings (the full schedule,
    MESH_RESTARTS restarts in one batch from seed 0) over two ranks on
    cuda:0, against the chain's reconstruct stage, the same settings on
    one card (`ref`); (ii) 3 restarts over 2 ranks, run as (vi),
    --distributed through the CLI; (iii) checkpointing under 2 ranks and
    (iv) the average worker on (i)'s archive over the same 2 ranks,
    against 1 card; (vii) several cards, where there are; run (v) closes
    phase production. → the mesh's launch
    counts (every rank's)."""
    import json
    import os
    import tempfile
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.ops.integrate import SphericalIntegrator
    from xframe_tpu_torch.parallel.mesh import CheckpointingRunner, make_mesh
    from xframe_tpu_torch.parallel.mesh import run_ranks
    from xframe_tpu_torch.projects.fxs.fidelity import (
        align_batch_to_ground_truth)
    from xframe_tpu_torch.projects.fxs.reconstruct import _build_schedule
    from xframe_tpu_torch.projects.fxs.store import load_archive
    smi, launches, t_phase = nvidia_smi(), {}, time.perf_counter()
    mtip, ft, aux = ref.mtip, ref.ft, ref.aux
    sqrt_s = float(np.sqrt(aux["data_scale"]))
    schedule = _build_schedule(ref.rec_settings, ft)

    # (ii) and (vi): --distributed through the CLI, two processes on
    # cuda:0, 3 restarts of one cycle (a padded row trimmed), started
    # here to run beside (i) and checked after it
    home = os.environ["XFRAME_TPU_HOME"]
    settings = os.path.join(home, "mesh_cli.json")
    ov = mesh_overrides(MESH_ONE_CYCLE, structure_name="mesh_cli",
                        input={"invariants_path": ref.inv_path},
                        multi_start={"n_reconstructions": 3,
                                     "batch_size": 0, "seed": 1})
    with open(settings, "w") as f:     # a settings file stands alone
        json.dump(select_worker("fxs", "reconstruct", "tutorial",
                                overrides=ov, device="cuda").settings, f)
    finish_cli = start_mesh_cli(home, settings)

    # (i) the worker over two ranks against the one-card batch
    w, res, wall = mesh_worker(torch, mesh_overrides(
        MESH_REFERENCE, {"mesh": {"restarts": 2},
                         "IO": NO_VTK["reconstruct"]}))
    add_counts(launches, w.rank_launches)
    rho0 = aux["initial_density_batch"](0, MESH_RESTARTS)
    rho0_h = rho0.cpu().numpy()
    rows = match_restarts(np, res["reconstruction_results"], rho0_h, sqrt_s,
                          "(i)")
    ref_rows = match_restarts(np, ref.rec["reconstruction_results"], rho0_h,
                              sqrt_s, "(i) one card")
    one_s = rank_rows_bitwise(torch, np, res, rows, mtip, schedule, rho0, 2,
                              "(i)")
    got = {i: res["reconstruction_results"][str(k)]
           for k, i in enumerate(rows)}
    want = {i: ref.rec["reconstruction_results"][str(k)]
            for k, i in enumerate(ref_rows)}
    first, series = 0.0, 0.0
    for i in got:
        for col in ("main", "reciprocal"):
            a, b = got[i]["error_dict"][col], want[i]["error_dict"][col]
            first = max(first, float(abs(a[0] - b[0]) / abs(b[0])))
            series = max(series, float(np.abs(a - b).max()))
        check(bool(np.isfinite(got[i]["real_density"]).all()
                   and np.isfinite(got[i]["error_dict"]["main"]).all()),
              f"mesh (i): restart {i} is not finite")
    w_int = SphericalIntegrator(ft.rs, ft.sht.n_theta, ft.sht.n_phi,
                                device="cuda").w_broadcast
    corrs = align_batch_to_ground_truth(
        [res["reconstruction_results"][str(k)]["real_density"]
         for k in range(len(rows))], ref.shapes, ft, w_int)[0]
    layout = archive_layout(np, load_archive(w.saved[0]))
    same_layout = layout == archive_layout(np, load_archive(ref.saved))
    mesh_line(smi, run="(i) worker", ranks=2, devices=MESH_DEVICES,
              restarts=MESH_RESTARTS, wall_seconds=wall,
              timing=res["timing"], one_card_timing=ref.timing,
              one_card_rank_rows_seconds=one_s, rows_of_ranks=rows,
              rank_launches=w.rank_launches,
              first_iteration_rel_to_one_card=first,
              error_series_max_abs_diff_to_one_card=series,
              first_tol=MESH_FIRST_TOL, restart_correlations=corrs,
              best_correlation=float(max(corrs)), bound=BEST_MIN,
              archive_layout_equal=same_layout, note=MESH_NOTE)
    check(first <= MESH_FIRST_TOL, f"mesh (i): the first iteration departs "
          f"from the one-card batch by {first}")
    check(max(corrs) > BEST_MIN, f"mesh (i): the best restart correlates "
          f"{max(corrs)} with the truth, not above {BEST_MIN}")
    check(same_layout, "mesh (i): the archive's keys, dtypes or shapes "
          "differ from the one-card archive's")

    t_cli = finish_cli()
    run2 = os.path.join(home, "data", "fxs", "reconstructions", "mesh_cli",
                        "run_1")
    res2 = load_archive(os.path.join(run2, next(
        f for f in sorted(os.listdir(run2)) if f.startswith("data."))))
    short = _build_schedule(select_worker(
        "fxs", "reconstruct", settings, device="cuda").settings, ft)
    rho0 = aux["initial_density_batch"](1, 3)
    rows2 = match_restarts(np, res2["reconstruction_results"],
                           rho0.cpu().numpy(), sqrt_s, "(ii)")
    rank_rows_bitwise(torch, np, res2, rows2, mtip, short, rho0, 2, "(ii)")
    finite = all(np.isfinite(v["real_density"]).all()
                 for v in res2["reconstruction_results"].values())
    mesh_line(smi, run="(ii, vi) uneven, --distributed", processes=2,
              devices=MESH_DEVICES, restarts=3, padded_rows=1,
              seconds_beside_i=t_cli, rows_of_ranks=rows2,
              finite=bool(finite), note=MESH_NOTE)
    check(finite, "mesh (ii): a restart of the --distributed run is not "
          "finite")

    # (iii) checkpointing and (iv) the average worker on (i)'s archive,
    # both over one pair of ranks; the file in a one-card runner, the
    # average against one card
    avg_ov = {"reconstruction_files": [w.saved[0]],
              "IO": copy.deepcopy(NO_VTK["average"])}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.npz")
                 for k in ("ck", "one_chunk")}
        t0 = time.perf_counter()
        runs, exchanges, counts, a2, t_a2 = run_ranks(
            make_mesh(devices=MESH_DEVICES), mesh_checkpoint_rank,
            mesh_overrides(MESH_ONE_CYCLE), paths, avg_ov)
        wall3 = time.perf_counter() - t0
        add_counts(launches, counts)
        (fs, fe), (rs, re) = runs["full"], runs["resumed"]
        bitwise = np.array_equal(fe, re) and all(
            np.array_equal(fs[k], rs[k])
            for k in ("best_err", "best_rho", "best_mask", "rho", "support"))
        ck = dict(np.load(paths["one_chunk"]))
        one = CheckpointingRunner(mtip, short,
                                  checkpoint_path=paths["one_chunk"])
        o_state, o_err = one(aux["initial_density_batch"](2, 2))
        o_err = o_err.cpu().numpy()
        loads = (ck["rho"].shape[0] == 2 and int(ck["chunk_index"]) == 1
                 and np.array_equal(o_err[:, :ck["errors"].shape[1]],
                                    ck["errors"])
                 and bool(np.isfinite(o_err).all()))
        mesh_line(smi, run="(iii) checkpoint", ranks=2, restarts=2,
                  wall_seconds_with_iv=wall3,
                  resumed_bitwise_uninterrupted=bitwise,
                  checkpoint_bytes=os.path.getsize(paths["one_chunk"]),
                  checkpoint_rows=int(ck["rho"].shape[0]),
                  one_card_resume_ok=loads, exchanges=exchanges,
                  note=MESH_NOTE)
    check(bitwise, "mesh (iii): the resumed 2-rank run differs from the "
          "uninterrupted one")
    check(loads, "mesh (iii): the 2-rank checkpoint does not resume in a "
          "one-card CheckpointingRunner")
    t0 = time.perf_counter()
    a1 = select_worker("fxs", "average", "tutorial", overrides=avg_ov,
                       device="cuda").run()
    t_a1 = time.perf_counter() - t0
    d1 = a1["average"]["real_density"]
    avg_diff = float(np.abs(a2["average"]["real_density"] - d1).max()
                     / np.abs(d1).max())
    ang = a1["rotation_metric"]["angles"]
    ang_diff = float(np.abs(a2["rotation_metric"]["angles"] - ang).max()
                     / max(np.abs(ang).max(), 1e-30))
    mesh_line(smi, run="(iv) average", ranks=2, seconds_2_ranks=t_a2,
              seconds_1_card=t_a1, average_rel_diff=avg_diff,
              angles_rel_diff=ang_diff, tol=MESH_AVERAGE_TOL,
              aligned=len(a2["aligned"]), note=MESH_NOTE)
    check(avg_diff <= MESH_AVERAGE_TOL and ang_diff <= MESH_AVERAGE_TOL,
          f"mesh (iv): 2 ranks against 1: average {avg_diff}, angles "
          f"{ang_diff}")

    # (vii) several cards
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        mesh_line(smi, run="(vii) several cards", cards=n_cards,
                  not_run="one card: restarts/hour on 2 cards against 1 and "
                          "--device cuda:1 were not run")
    else:
        cards = [f"cuda:{i}" for i in range(2)]
        w7, res7, wall7 = mesh_worker(torch, mesh_overrides(
            MESH_REFERENCE, {"mesh": {"restarts": 2}}), devices=cards)
        add_counts(launches, w7.rank_launches)
        out, t_dev = cli_subprocess(["--device", "cuda:1", "fxs",
                                     "reconstruct", settings], home)
        rate = {k: 3600.0 * MESH_RESTARTS / t["phasing_s"]
                for k, t in (("1 card", ref.timing),
                             ("2 cards", res7["timing"]))}
        mesh_line(smi, run="(vii) several cards", cards=n_cards,
                  restarts_per_hour=rate, wall_seconds_2_cards=wall7,
                  device_cuda1_seconds=t_dev)
    mesh_line(smi, run="total", seconds=time.perf_counter() - t_phase,
              launches={k: v for k, v in launches.items() if v})
    for k in ("forward", "inverse", "forward_real_abs2",
              "inverse_real_project_fwd", "synthesize_update",
              "hankel_synthesize"):
        check(launches.get(k, 0) > 0, f"mesh: no rank launched {k}")
    return launches


def mesh_production_rank(mesh, host_paths, restarts):
    """Phase mesh (v) on one rank: the production problem (rank 0 takes
    phase production's, another rank builds it on the host grid and true
    density phase production saved), `restarts` restarts from seed 0 over
    the mesh through one shrink-wrap chunk (HIO MESH_PRODUCTION_HIO +
    SW). → on rank 0
    (state's best errors, errors, the exchanges, every rank's launch
    counts)."""
    from xframe_tpu_torch.parallel.mesh import MultiStartRunner
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    import numpy as np
    p = _PRODUCTION.get("p")
    if p is None:
        from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
        from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
        host = SimpleNamespace(shapes=host_paths["shapes"],
                               **{k: np.load(host_paths[k], mmap_mode="r")
                                  for k in ("grid", "rho_true")})
        p = make_demo_problem(PROD["n_q"], PROD["l_max"],
                              n_theta=PROD["n_theta"], n_phi=PROD["n_phi"],
                              procrustes_method="newton_schulz_pallas",
                              ns_schedule=DEFAULT_SCHEDULE, host=host,
                              device=mesh.device)
    sigma = p.mtip.sw.default_sigma
    schedule = [Segment("HIO", MESH_PRODUCTION_HIO,
                        betas=np.full(MESH_PRODUCTION_HIO, 0.5),
                        ft_stab=True),
                Segment("SW", sigma=sigma, threshold=0.1)]
    runner = MultiStartRunner(p.mtip, schedule, mesh=mesh)
    state, errors = runner(p.initial_density_batch(0, restarts))
    if mesh.rank != 0:
        return None
    return (state.best_err.cpu().numpy(), errors.cpu().numpy(),
            {k: dict(v) for k, v in mesh.exchanges.items()},
            runner.rank_launches)


# phase production's problem, for rank 0 of run (v) in this process
_PRODUCTION = {}


def phase_mesh_production(torch, np, p):
    """Phase mesh (v): the production problem over two ranks on cuda:0, 2
    restarts, one shrink-wrap chunk; the gather's seconds and bytes (and
    rank 0's wait for the other rank at it). → the ranks' launch
    counts."""
    import os
    import tempfile
    from xframe_tpu_torch.ops import fused_projection
    from xframe_tpu_torch.parallel.mesh import make_mesh, run_ranks
    smi, t0 = nvidia_smi(), time.perf_counter()
    fused_projection.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"shapes": p.shapes}
        for k in ("grid", "rho_true"):
            paths[k] = os.path.join(tmp, f"{k}.npy")
            np.save(paths[k], np.asarray(getattr(p, k)))
        _PRODUCTION["p"] = p
        try:
            best, errors, exchanges, counts = run_ranks(
                make_mesh(devices=MESH_DEVICES), mesh_production_rank, paths,
                2)
        finally:
            _PRODUCTION.clear()
    launches = {}
    add_counts(launches, counts)
    gather = exchanges.get("state", {})
    mesh_line(smi, run="(v) production", ranks=2, restarts=2,
              seconds=time.perf_counter() - t0,
              gather_seconds=gather.get("seconds", 0.0),
              gather_wait_seconds=gather.get("wait_seconds", 0.0),
              gather_bytes=gather.get("bytes", 0),
              best_err=best.tolist(), rank_launches=counts, note=MESH_NOTE)
    check(bool(np.isfinite(errors).all() and np.isfinite(best).all()),
          "mesh (v): the production restarts are not finite")
    check(all(c.get("fused_projection_bucket", 0) > 0 for c in counts),
          "mesh (v): a rank did not launch B8")
    return launches


# ------------------------------------------------------------ options
# the reconstruct options' runs on the tutorial chain's invariants at full
# tutorial width: 2 restarts, one cycle of the tutorial schedule (HIO 60 +
# SW + ER 40), the first iteration held against the CPU (the bound of
# tests/test_torch_options.py), replay against eager as REPLAY_TOL
OPTIONS_RESTARTS = 2
OPTIONS_CPU_TOL = 1e-4
OPTIONS_SUPPORT_MARGIN = 1e-5   # of max A: points nearer the threshold
_LINKED = {"ft_stab": "link_to_enforce_initial_support",
           "link_to_enforce_initial_support": {"delay": 2}}
OPTIONS_RUNS = {
    # (i) the fused iteration: B5 with the grid of weights and the gate
    "fused": {
        "projections": {"real": {"projections": {"support": {
            "initial_support": {"type": "auto_correlation"}}}}},
        "main_loop": {"sub_loops": {"main": {"methods": {
            "HIO": dict(iterations=60, **_LINKED),
            "ER": dict(iterations=40, **_LINKED)}}}}},
    # (ii) the stepwise iteration
    "stepwise": {
        "main_loop": {"error": {"methods": {
            "reciprocal": {"calculate": ["l2_projection_diff",
                                         "deg2_invariant_l2_diff"]},
            "main": {"metrics": {"real": ["l2_projection_diff"],
                                 "reciprocal": ["l2_projection_diff"]},
                     "type": "max"}}}},
        "projections": {
            "reciprocal": {"ns_sigma_min": 1e-5, "number_of_particles": {
                "estimate": {"apply": True, "estimate_in": ["ER"],
                             "project": True}}},
            "real": {"shrink_wrap": {"mode": "fixed_volume", "fixed_volume":
                                     {"method": "bucketed"}}}}},
}


def options_overrides(inv_path, extra):
    """The tutorial reconstruct settings on the invariants at inv_path,
    OPTIONS_RESTARTS restarts in one chunk from seed 0, the main loop's one
    cycle only, and `extra`."""
    from xframe_tpu_torch.settings import deep_update
    return deep_update({
        "input": {"invariants_path": inv_path},
        "multi_start": {"n_reconstructions": OPTIONS_RESTARTS,
                        "batch_size": OPTIONS_RESTARTS, "seed": 0},
        "main_loop": {"sub_loops": {"order": ["main"],
                                    "main": {"iterations": 1}}},
        "IO": copy.deepcopy(NO_VTK["reconstruct"])}, extra)


def spy_options(worker, chunks, seen):
    """spy_worker, and besides: the run's (ρ0, state, errors) in
    seen["run"] and each linked segment's gates in seen["gates"]. → the
    function that removes the spies."""
    remove_inner = spy_worker(worker, chunks, seen)
    inner_setup = worker.setup_mtip
    gates = seen.setdefault("gates", [])

    def setup_mtip(inv):
        mtip, ft, aux = inner_setup(inv)
        ft_gate, run_batch = mtip._ft_gate, mtip.run_batch

        def spy_ft_gate(state, seg):
            g = ft_gate(state, seg)
            if g is not None:
                gates.append((seg.method, g.cpu().numpy()))
            return g

        def spy_run_batch(rho0, schedule):
            out = run_batch(rho0, schedule)
            seen["run"] = (rho0,) + tuple(out)
            return out
        mtip._ft_gate, mtip.run_batch = spy_ft_gate, spy_run_batch
        return mtip, ft, aux
    worker.setup_mtip = setup_mtip

    def remove():
        remove_inner()
        if "mtip" in seen:
            del seen["mtip"]._ft_gate
    return remove


def first_iteration_vs_cpu(np, cpu_mtip, state, schedule, at, errors):
    """The segment of `schedule` holding global iteration `at`, run one
    iteration from `state` on the CPU MTIP, against the card's errors at
    `at`. → (the CPU's error columns (B, columns), their largest relative
    difference to the card's)."""
    from xframe_tpu_torch.projects.fxs.phasing import PhasingState, Segment
    pos = 0
    for seg in schedule:
        if seg.method in ("HIO", "ER", "RAAR"):
            if pos == at:
                break
            pos += seg.n
    one = Segment(seg.method, 1, betas=seg.betas[:1], ft_stab=seg.ft_stab,
                  ft_stab_link_delay=seg.ft_stab_link_delay)
    cpu_mtip.register_schedule_dynamics(schedule)
    cpu_state = PhasingState(*[None if x is None else x.cpu()
                               for x in state])
    _, cpu = cpu_mtip.run_from(cpu_state, [one], materialize=False)
    cpu = cpu[:, 0].numpy()
    card = errors[:, at].cpu().numpy()
    rel = np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-30)
    rel[(card == 0) & (cpu == 0)] = 0.0
    return cpu, float(rel.max())


def cpu_twin(overrides, card_aux, settings="tutorial"):
    """The CPU worker's set-up on the same settings, its MTIP rebuilt on the
    card's initial support, so that the error weights and B5's weight grid
    are the card's (an auto-correlation support may differ near its
    threshold). → (CPU worker, MTIP, ft, aux, schedule)."""
    from xframe_tpu_torch.main import select_worker
    w = select_worker("fxs", "reconstruct", settings, overrides=overrides,
                      device="cpu")
    mtip, ft, aux = w.setup_mtip(w._load_invariants())
    mtip.set_initial_support(card_aux["initial_support"])
    return w, mtip, ft, aux, w._build_schedule(ft)


def first_errors(mtip, rho0, schedule):
    """The error columns (B, columns) of the first phasing iteration of
    `schedule` from the densities rho0, on mtip's device."""
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    seg = next(s for s in schedule if s.method in ("HIO", "ER", "RAAR"))
    one = Segment(seg.method, 1, betas=seg.betas[:1], ft_stab=seg.ft_stab,
                  ft_stab_link_delay=seg.ft_stab_link_delay)
    mtip.register_schedule_dynamics(schedule)
    _, errors = mtip.run_from(mtip.initial_state_batch(rho0), [one],
                              materialize=False)
    return errors[:, 0]


def rel_distance(np, got, want):
    """max |got − want| / |want| over two error arrays (0 where both 0)."""
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    want = want.cpu().numpy() if hasattr(want, "cpu") else np.asarray(want)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    rel[(got == 0) & (want == 0)] = 0.0
    return float(rel.max())


def projected_intensity(mtip, rho):
    """The stepwise iteration's I_new before the particle-number estimate,
    for densities rho: the phase anchor, |FT ρ|², the data projection of
    its coefficients and their real synthesis."""
    if mtip.fix_global_phase:
        rho = mtip._anchor_global_phase(rho)
    psi = mtip.ft.forward(rho)
    ilm = mtip._analyse((psi * psi.conj()).real)
    return mtip._synthesize_real(mtip.rc(ilm))


def float64_mtip(overrides, device, support=None):
    """The worker's MTIP on the tutorial settings plus `overrides` under
    precision float64 on `device`, on `support` where given."""
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.settings import deep_update
    wide = deep_update(copy.deepcopy(overrides), {"precision": "float64"})
    w = select_worker("fxs", "reconstruct", "tutorial", overrides=wide,
                      device=device)
    mtip = w.setup_mtip(w._load_invariants())[0]
    if support is not None:
        mtip.set_initial_support(support)
    return mtip


def pn_scan_check(torch, np, overrides, pre, mtip, cpu_mtip):
    """C.3: the particle-number estimate's scan objective from the card's
    state `pre` (after HIO + SW) at the candidates the card and the CPU
    pick, in float32 (both devices) and again in float64 (both devices,
    the worker's set-up under precision float64). → the line's fields."""
    out = {}
    runs = [("float32", "card", mtip, pre.rho),
            ("float32", "cpu", cpu_mtip, pre.rho.cpu())]
    for dev in ("cuda", "cpu"):
        m64 = float64_mtip(overrides, dev)
        runs.append(("float64", "card" if dev == "cuda" else "cpu", m64,
                     pre.rho.to(m64.device).to(torch.complex128)))
    grads = {}
    for prec, dev, m, rho in runs:
        grads[prec, dev] = m.rc.particle_number_scan(
            projected_intensity(m, rho)).double().cpu().numpy()
    idx = {k: g.argmax(-1) for k, g in grads.items()}
    Ns = mtip.rc.pn_Ns.cpu().numpy()
    for (prec, dev), g in grads.items():
        out[f"objective_{prec}_{dev}_at_card_cpu_steps"] = [
            [float(g[r, idx["float32", "card"][r]]),
             float(g[r, idx["float32", "cpu"][r]])] for r in range(len(g))]
        out[f"n_hat_{prec}_{dev}"] = Ns[idx[prec, dev]].tolist()
    out["steps_agree_float64"] = bool(np.array_equal(idx["float64", "card"],
                                                     idx["float64", "cpu"]))
    return out


def options_run(torch, np, name, overrides):
    """One run of phase `options` through select_worker + run on the card,
    and its checks against the CPU worker's set-up. → its launch counts
    (set-up, run and collection)."""
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.ops.polar_schedule import polar_express_schedule
    from xframe_tpu_torch.projects.fxs.phasing import PhasingState
    from xframe_tpu_torch.projects.fxs.reconstruct import pad_coeff_dense
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    worker = select_worker("fxs", "reconstruct", "tutorial",
                           overrides=overrides, device="cuda")
    chunks, seen, counts = [], {}, {}
    remove = spy_options(worker, chunks, seen)
    t0 = time.perf_counter()
    try:
        with kernel_instances(counts):
            res = worker.run()
            torch.cuda.synchronize()
    finally:
        remove()
    wall = time.perf_counter() - t0
    mtip, schedule, aux = seen["mtip"], seen["schedule"], seen["aux"]
    rho0, state, errors = seen["run"]
    timing = res["timing"]
    n_iter = sum(s.n for s in schedule if s.method in ("HIO", "ER", "RAAR"))
    emit(phase="options", run=name, seconds=wall, setup_s=timing["setup_s"],
         phasing_s=timing["phasing_s"], iterations=n_iter,
         restarts=OPTIONS_RESTARTS,
         s_per_iteration_per_restart=timing["sec_per_iteration_per_restart"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         fused=mtip._fi is not None, best_tracking=mtip.best_mode,
         error_names=mtip.error_names,
         launches={k: v for k, v in counts.items() if v})
    checks = {}

    # launches of the run, replayed iterations included
    run_counts, anchors = chunks[0]
    replayed = replay_iterations(np, schedule, anchors)
    implied = implied_launches(schedule, mtip, replayed=replayed)
    checks["launches"] = run_counts == implied
    emit(phase="options_launches", run=name, replayed_iterations=replayed,
         launches=run_counts, implied_launches=implied)

    # the CPU worker's set-up on the same settings and the card's support
    t0 = time.perf_counter()
    cpu_worker, cpu_mtip, cpu_ft, cpu_aux, cpu_schedule = cpu_twin(
        overrides, aux)
    checks["schedule"] = [(a.method, a.n, a.ft_stab, a.ft_stab_link_delay)
                          for a in cpu_schedule] == [
        (a.method, a.n, a.ft_stab, a.ft_stab_link_delay) for a in schedule]
    cpu_err, rel = first_iteration_vs_cpu(
        np, cpu_mtip, mtip.initial_state_batch(rho0), schedule, 0, errors)
    checks["first_iteration"] = rel <= OPTIONS_CPU_TOL
    line = dict(first_iteration_rel_diff=rel, tol=OPTIONS_CPU_TOL,
                cpu_errors=cpu_err.tolist(),
                card_errors=errors[:, 0].cpu().numpy().tolist())

    if name == "fused":
        # B5 on its grid form with the gate; the initial support away from
        # the threshold; replay against eager; the enforce history and the
        # gates against the CPU's bookkeeping on the card's errors
        checks["grid_weights"] = mtip._k4_weights().dim() == 3
        A = cpu_worker._synthesize(cpu_ft, pad_coeff_dense(
            cpu_aux["proj"], cpu_ft.qs.shape[0], cpu_ft.sht.l_max)
            ).real.numpy()
        a_max = float(A.max())
        thr = float(overrides["projections"]["real"]["projections"].get(
            "support", {}).get("initial_support", {}).get(
            "auto_correlation", {}).get("threshold", 0.01)) * a_max
        clear = np.abs(A - thr) > OPTIONS_SUPPORT_MARGIN * a_max
        sup_card = np.asarray(aux["initial_support"])
        sup_cpu = np.asarray(cpu_aux["initial_support"])
        mismatched = int((sup_card != sup_cpu)[clear].sum())
        checks["initial_support"] = mismatched == 0 and not sup_card.all()
        eager = copy.copy(mtip)
        eager.best_mode = "eager"
        e_state, e_errors = eager.run_batch(rho0, schedule)
        scale = float(e_state.best_rho.abs().max())
        replay_diff = float((e_state.best_rho - state.best_rho).abs().max()
                            ) / scale
        checks["replay_vs_eager"] = bool(torch.equal(errors, e_errors)) \
            and replay_diff <= REPLAY_TOL
        del e_state, e_errors, eager
        hist = torch.ones((OPTIONS_RESTARTS, mtip._link_hist_len),
                          dtype=torch.bool)
        gates_cpu, pos = [], 0
        for seg in schedule:
            if seg.method in ("SW", "SW_center"):
                enforce = errors[:, pos - 1, 0].cpu() > cpu_mtip.enforce_limit
                hist = torch.cat([hist[:, 1:], enforce[:, None]], dim=1)
            elif seg.method in ("HIO", "ER", "RAAR"):
                g = cpu_mtip._ft_gate(PhasingState(*([None] * 6),
                                                   enforce_hist=hist), seg)
                if g is not None:
                    gates_cpu.append((seg.method, g.numpy()))
                pos += seg.n
        hist_cpu = hist.numpy()
        checks["enforce_hist"] = np.array_equal(
            state.enforce_hist.cpu().numpy(), hist_cpu)
        checks["gates"] = len(gates_cpu) == len(seen["gates"]) and all(
            a[0] == b[0] and np.array_equal(a[1], b[1])
            for a, b in zip(gates_cpu, seen["gates"]))
        # C.2's referee: the first iteration in float64 on the card's
        # support, against which the card's and the CPU's float32 are held
        ref = first_errors(float64_mtip(overrides, "cuda",
                                        aux["initial_support"]),
                           rho0, schedule)
        line.update(card_vs_float64=rel_distance(np, errors[:, 0], ref),
                    cpu_vs_float64=rel_distance(np, cpu_err, ref),
                    float64_errors=ref.cpu().tolist())
        line.update(support_mismatched_clear=mismatched,
                    points_left_out=int((~clear).sum()), points=clear.size,
                    support_voxels=int(sup_card.sum()),
                    replay_rel_diff=replay_diff,
                    anchor_len=[a[1].tolist() for a in anchors],
                    enforce_hist=state.enforce_hist.cpu().numpy().tolist(),
                    gates=[(m, g.tolist()) for m, g in seen["gates"]])
    else:
        # the first ER iteration, which estimates the particle number, from
        # the card's state after HIO 60 + SW; the bucketed support's volume;
        # the computed schedule
        head = schedule[:2]
        pre = mtip.run_from(mtip.initial_state_batch(rho0), head,
                            materialize=False)[0]
        at = head[0].n
        cpu_er, rel_er = first_iteration_vs_cpu(np, cpu_mtip, pre, schedule,
                                                at, errors)
        col = mtip.error_names.index("n_particles")
        Ns = mtip.rc.pn_Ns.cpu().numpy()
        n_card = errors[:, at, col].cpu().numpy()
        steps = np.abs(np.searchsorted(Ns, n_card)
                       - np.searchsorted(Ns, cpu_er[:, col]))
        checks["n_hat"] = bool((steps <= 1).all() and (n_card >= 1).all())
        line["particle_number_scan"] = pn_scan_check(
            torch, np, overrides, pre, mtip, cpu_mtip)
        # the other columns where both took the same estimate: under
        # `project` a neighbouring one scales I_new otherwise
        same = steps == 0
        others = [j for j in range(cpu_er.shape[1]) if j != col]
        checks["first_er_iteration"] = bool(np.allclose(
            errors[:, at].cpu().numpy()[same][:, others],
            cpu_er[same][:, others], rtol=OPTIONS_CPU_TOL, atol=0))
        sw = mtip.sw
        w = sw.vol_weights.double()
        old = (w * sw.initial_support).sum()
        target = torch.clamp(sw.volume_fraction * w.sum(),
                             (1 - sw.max_volume_change) * old,
                             (1 + sw.max_volume_change) * old)
        vols = (w * state.support).sum(_GRID_DIMS)
        over = (vols - target).cpu().numpy()
        checks["bucketed_volume"] = bool(
            ((over >= 0) & (over < float(w.max()))).all())
        sched_host = polar_express_schedule(1e-5)
        checks["ns_schedule"] = tuple(mtip.rc.ns_schedule) == sched_host \
            and len(sched_host) == 11
        del pre
        line.update(first_er_rel_diff=rel_er, first_er_held=same.tolist(),
                    n_hat_card=n_card.tolist(),
                    n_hat_cpu=cpu_er[:, col].tolist(),
                    n_hat_steps=steps.tolist(),
                    support_volume_over_target=over.tolist(),
                    point_weight_max=float(w.max()),
                    ns_schedule_steps=len(mtip.rc.ns_schedule))
    emit(phase="options_checks", run=name, checks=checks,
         cpu_seconds=time.perf_counter() - t0, **line)
    check(all(checks.values()), f"options run {name}: checks failed: "
          f"{[k for k, v in checks.items() if not v]}")
    for r in res["reconstruction_results"].values():
        check(bool(np.isfinite(r["real_density"]).all()
                   and np.isfinite(r["error_dict"]["main"]).all()),
              f"options run {name}: a restart is not finite")
    return counts


def phase_options(torch, np, inv_path):
    """Phase `options`: the reconstruct worker on its tutorial settings
    with the options the port once refused, on the tutorial chain's
    invariants (OPTIONS_RUNS: (i) fused with the auto-correlation support
    and linked ft-stab of delay 2 under replay, (ii) stepwise with the
    configured error metrics, the particle-number estimate, the bucketed
    shrink-wrap and ns_sigma_min 1e-5). → the launch counts of both."""
    total = dict.fromkeys(counters(), 0)
    for name, extra in OPTIONS_RUNS.items():
        counts = options_run(torch, np, name,
                             options_overrides(inv_path, extra))
        for k in total:
            total[k] += counts[k]
    return total


# ------------------------------------------------------------ bf16 run
# fourier_transform.fused_bf16_tables through the reconstruct worker on the
# chain's invariants: phase options' settings (2 restarts, one cycle of HIO
# 60 + SW + ER 40, its tutorial defaults: the fused iteration under replay)
# with the key, beside the same run without it; then the variants
# k2_fwd=False and k1_abs2=True of its MTIP (B11, B12) over the cycle's
# first BF16_VARIANT_ITERS HIO iterations from its initial densities
BF16_RUN = {"fourier_transform": {"fused_bf16_tables": True}}
# the first iteration's errors, relative: against the CPU worker with the
# key (its plain bf16 path; 7.4e-6 on an NVIDIA H100), and a variant's
# against the run's (1.9e-7 and 0); the float32 runs' bound
BF16_CPU_TOL = OPTIONS_CPU_TOL
BF16_VARIANT_TOL = 1e-4
BF16_VARIANT_ITERS = 20


def bf16_worker_run(torch, np, inv_path, extra):
    """The reconstruct worker with options_overrides(inv_path, extra)
    through select_worker + run on the card, spied as phase options' runs.
    → SimpleNamespace(res, counts (the MTIP's launches in the chunks and
    the collection), instances (kernel_instances' counts: every FusedSHT
    and FusedIteration built in the run, the MTIP's since its last reset),
    chunks, wall, peak, overrides, and spy_options' mtip, ft, aux,
    schedule, run, collect_counts)."""
    from xframe_tpu_torch.main import select_worker
    overrides = options_overrides(inv_path, extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    worker = select_worker("fxs", "reconstruct", "tutorial",
                           overrides=overrides, device="cuda")
    chunks, seen, instances = [], {}, {}
    remove = spy_options(worker, chunks, seen)
    t0 = time.perf_counter()
    try:
        with kernel_instances(instances):
            res = worker.run()
            torch.cuda.synchronize()
    finally:
        remove()
    wall = time.perf_counter() - t0
    # the spies set the MTIP's counts to 0 as each chunk and the collection
    # start: their sums are the run's launches
    counts = dict.fromkeys(counters(), 0)
    for part in [c for c, _ in chunks] + [seen["collect_counts"]]:
        for k, v in part.items():
            counts[k] += v
    return SimpleNamespace(res=res, counts=counts, instances=instances,
                           chunks=chunks, wall=wall,
                           peak=torch.cuda.max_memory_allocated(),
                           overrides=overrides, **seen)


def phase_bf16(torch, np, inv_path):
    """Phase bf16 (BF16_RUN): the worker with fused_bf16_tables and its
    float32 twin, each a line bf16 (seconds, s/iteration/restart, peak
    memory, launches). Checks (line bf16_checks): the run's launches the
    schedule's implied ones in the bf16 forms' counters, no float32 form
    launched in the run (its collection included, nor by any FusedSHT or
    FusedIteration built in it), every restart
    finite and its final error below half the mean of its first five, the
    first iteration within BF16_CPU_TOL of the CPU worker's with the key
    (its plain bf16 path; cpu_twin); each variant's launches as implied,
    its first iteration within BF16_VARIANT_TOL of the run's, finite.
    Printed: the distance from the float32 run (first and last iteration's
    errors, the best densities), each restart's correlation to the truth
    beside the float32 run's. → {"bf16": the run's launch counts,
    "bf16_k2_fwd", "bf16_k1_abs2": the variants'}."""
    from xframe_tpu_torch.ops import fused_mtip, fused_sht
    from xframe_tpu_torch.ops.integrate import SphericalIntegrator
    from xframe_tpu_torch.projects.fxs.fidelity import \
        align_batch_to_ground_truth
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    from xframe_tpu_torch.settings import load_settings
    runs = {"float32": bf16_worker_run(torch, np, inv_path, {}),
            "bf16": bf16_worker_run(torch, np, inv_path, BF16_RUN)}
    for name, r in runs.items():
        n_iter = sum(s.n for s in r.schedule
                     if s.method in ("HIO", "ER", "RAAR"))
        emit(phase="bf16", run=name, seconds=r.wall,
             setup_s=r.res["timing"]["setup_s"],
             phasing_s=r.res["timing"]["phasing_s"], iterations=n_iter,
             restarts=OPTIONS_RESTARTS,
             s_per_iteration_per_restart=r.res["timing"][
                 "sec_per_iteration_per_restart"],
             max_memory_allocated=r.peak,
             table_dtype=str(r.mtip.ft.harmonic.table_dtype),
             launches={k: v for k, v in r.counts.items() if v})
    b, f32 = runs["bf16"], runs["float32"]
    mtip, schedule = b.mtip, b.schedule
    rho0, state, errors = b.run
    check(mtip.ft.harmonic.table_dtype == torch.bfloat16
          and mtip._fi is not None, "the bf16 run does not run the fused "
          "iteration on bf16 tables")
    checks = {}
    run_counts, anchors = b.chunks[0]
    replayed = replay_iterations(np, schedule, anchors)
    implied = implied_launches(schedule, mtip, replayed=replayed)
    checks["launches"] = run_counts == implied
    checks["float32_forms_idle"] = not any(
        b.counts[k] or b.instances[k]
        for k in fused_sht.METHODS + fused_mtip.METHODS)
    errs = errors.cpu().numpy()
    main = errs[:, :, 0]
    checks["finite"] = bool(np.isfinite(errs).all()) and all(
        bool(np.isfinite(v["real_density"]).all())
        for v in b.res["reconstruction_results"].values())
    checks["converges"] = bool(all(main[r, -1] < 0.5 * main[r, :5].mean()
                                   for r in range(len(main))))
    t0 = time.perf_counter()
    _, cpu_mtip, _, _, _ = cpu_twin(b.overrides, b.aux)
    checks["cpu_bf16"] = cpu_mtip.ft.harmonic.table_dtype == torch.bfloat16
    cpu_err, rel_cpu = first_iteration_vs_cpu(
        np, cpu_mtip, mtip.initial_state_batch(rho0), schedule, 0, errors)
    checks["first_iteration"] = rel_cpu <= BF16_CPU_TOL
    cpu_s = time.perf_counter() - t0
    del cpu_mtip

    # the distance from the float32 run, and both runs against the truth
    e32 = f32.run[2]
    best, best32 = state.best_rho, f32.run[1].best_rho
    shapes = load_settings("simulate_ccd", "tutorial")["shapes"]
    ft = f32.ft
    w = SphericalIntegrator(ft.rs, ft.sht.n_theta, ft.sht.n_phi,
                            device="cuda").w_broadcast
    corr = {}
    for name, r in runs.items():
        res = r.res["reconstruction_results"]
        corr[name] = align_batch_to_ground_truth(
            [res[str(i)]["real_density"] for i in range(len(res))], shapes,
            ft, w)[0]

    # the variants over the cycle's first HIO iterations, eager
    seg = schedule[0]
    n = BF16_VARIANT_ITERS
    short = [Segment(seg.method, n, betas=seg.betas[:n], ft_stab=seg.ft_stab,
                     ft_stab_link_delay=seg.ft_stab_link_delay)]
    out = {"bf16": b.counts}
    variants = {}
    for path, kw in (("bf16_k2_fwd", {"k2_fwd": False}),
                     ("bf16_k1_abs2", {"k1_abs2": True})):
        m = copy.copy(mtip)
        m.best_mode = "eager"
        for k, v in kw.items():
            setattr(m, k, v)
        torch.cuda.synchronize()
        reset_launches(m)
        t1 = time.perf_counter()
        _, e = m.run_batch(rho0, short)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        counts = launch_counts(m)
        rel = rel_distance(np, e[:, 0], errors[:, 0])
        # run_batch from the run's densities: no initial guess
        want = implied_launches(short, m)
        want["forward" + BF16] -= 2
        want["inverse" + BF16] -= 2
        checks[path + "_launches"] = counts == want
        checks[path + "_first_iteration"] = rel <= BF16_VARIANT_TOL
        checks[path + "_finite"] = bool(torch.isfinite(e).all())
        variants[path] = dict(seconds=seconds, first_iteration_rel_diff=rel,
                              launches={k: v for k, v in counts.items()
                                        if v})
        out[path] = counts
    emit(phase="bf16_checks", checks=checks,
         implied_launches={k: v for k, v in implied.items() if v},
         first_iteration_rel_diff=rel_cpu, tol=BF16_CPU_TOL,
         cpu_errors=cpu_err.tolist(), card_errors=errs[:, 0].tolist(),
         cpu_seconds=cpu_s,
         float32_first_iteration_rel_diff=rel_distance(np, errors[:, 0],
                                                       e32[:, 0]),
         float32_last_iteration_rel_diff=rel_distance(np, errors[:, -1],
                                                      e32[:, -1]),
         float32_best_rho_rel_diff=[
             float((best[i] - best32[i]).abs().max()
                   / best32[i].abs().max()) for i in range(len(best))],
         final_errors=main[:, -1].tolist(),
         float32_final_errors=e32[:, -1, 0].cpu().tolist(),
         truth_correlation=corr["bf16"],
         float32_truth_correlation=corr["float32"],
         variant_tol=BF16_VARIANT_TOL, variants=variants)
    check(all(checks.values()), f"bf16 run: checks failed: "
          f"{[k for k, v in checks.items() if not v]}")
    return out


# ------------------------------------------------------------ precision
# precision: float64 and fourier_transform.fused_sht: false: the plain
# transforms on the card, which only the settings choose. (i) and (ii) run
# on the chain's invariants beside phase options, (iv) on the 2D chain's,
# (iii) after phase production, (v) on the tutorial simulate settings
PRECISION_CPU_TOL = 1e-9     # float64 on the card against the CPU
PRECISION_KERNEL_TOL = 1e-4  # fused_sht false against the kernel path
PRECISION_B7_TOL = 1e-4      # B7 against its plain version on the card
PRECISION_CC_TOL = 1e-4      # simulate_ccd's CC, plain against kernels
PRECISION_PROD_ITERS = 10
PRECISION_RUNS = {
    "(i) float64": {"precision": "float64"},
    "(ii) fused_sht false": {"fourier_transform": {"fused_sht": False}},
}
# (vi): run (i)'s settings with the θ axis over two ranks on cuda:0, held
# to run (i) and to one-card iterations from its own states. HIO amplifies
# a rounding difference by orders of magnitude within 60 iterations (on
# the H100, (vi)'s distance from (i) grows from 3.5e-12 to 3.2e-3 in 30
# iterations, a one-card run's from a ρ0 moved by 9e-13 from 6.7e-12 to
# 7.1e-4), so (i)'s series holds (vi) only at the first iteration and after the
# shrink-wrap where both supports agree; at PRECISION_THETA_STEPS (every
# 5th iteration, the last before the shrink-wrap and the last) the ranks'
# state (joined θ rows) runs one iteration on one card, which must give
# (vi)'s errors of that iteration within the first iteration's bound, and
# the state before the shrink-wrap runs (i)'s shrink-wrap on one card,
# which must give (vi)'s support bit for bit
PRECISION_THETA = {"precision": "float64",
                   "mesh": {"restarts": 1, "theta": 2}}
PRECISION_THETA_TOLS = {"first": 1e-10, "after_sw": 1e-6}
PRECISION_THETA_STEPS = tuple(sorted(set(range(0, 100, 5)) | {59, 99}))
PRECISION_THETA_MAX_S = 45.0


def card_mtip(overrides, settings="tutorial", fused=True):
    """The worker's MTIP on the card on the tutorial settings plus
    `overrides` (the default kernel path), its fused iteration turned off
    with fused=False (the stepwise kernel path, FusedSHT kept)."""
    from xframe_tpu_torch.main import select_worker
    w = select_worker("fxs", "reconstruct", settings, overrides=overrides,
                      device="cuda")
    mtip = w.setup_mtip(w._load_invariants())[0]
    if not fused:
        mtip = copy.copy(mtip)
        mtip._fi, mtip.best_mode = None, "eager"
    return mtip


def precision_worker(torch, np, name, overrides, settings="tutorial"):
    """One run of phase precision through select_worker + run on the card,
    every kernel launch counted. → (seen: the worker's mtip, schedule,
    aux, ρ0, state and errors; the line; the checks)."""
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    worker = select_worker("fxs", "reconstruct", settings,
                           overrides=overrides, device="cuda")
    chunks, seen, counts = [], {}, {}
    remove = spy_options(worker, chunks, seen)
    t0 = time.perf_counter()
    try:
        with kernel_instances(counts):
            res = worker.run()
            torch.cuda.synchronize()
    finally:
        remove()
    wall = time.perf_counter() - t0
    mtip, (rho0, state, errors) = seen["mtip"], seen["run"]
    seen["saved"] = worker.saved[0]
    timing = res["timing"]
    first5 = errors[:, :5, 0].mean(1)
    line = dict(run=name, seconds=wall, setup_s=timing["setup_s"],
                phasing_s=timing["phasing_s"],
                iterations=int(errors.shape[1]), restarts=int(len(rho0)),
                s_per_iteration_per_restart=timing[
                    "sec_per_iteration_per_restart"],
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                dtype=str(state.rho.dtype), harmonic=type(mtip.sht).__name__,
                fused=mtip._fi is not None,
                final_errors=state.best_err.cpu().tolist(),
                first_five_mean=first5.cpu().tolist(),
                launches={k: v for k, v in counts.items() if v})
    checks = {
        "no_launches": not any(counts.values()),
        "plain_transforms": mtip._fi is None
        and not isinstance(mtip.sht, FusedSHT),
        "converges": bool((state.best_err < 0.5 * first5).all()),
        "finite": all(bool(np.isfinite(r["real_density"]).all())
                      for r in res["reconstruction_results"].values())}
    return seen, line, checks


def precision_theta_rank(mesh, overrides, n_theta, t_launch):
    """Precision (vi) on one rank of the θ mesh (a module-level function:
    the spawned rank imports it): the reconstruct worker on the rank's
    mesh, its MTIP's own error series (MTIP.run_batch's) kept, and at
    PRECISION_THETA_STEPS the iteration's input state (this rank's θ rows
    of an n_theta-row grid), parameters and errors. → on rank 0 (results,
    archive path, every rank's error series, {iteration: (ρ, support on
    the whole grid, β, method, ft_stab, error, reciprocal error)}, rank
    0's exchanges, every rank's launch counts, every rank's seconds from
    the launch to its start, each shrink-wrap's input (ρ and support on
    the whole grid, last errors, segment) and support after it)."""
    import itertools
    import torch
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    started = time.time() - t_launch
    own, steps, calls, sws = [], {}, itertools.count(), []
    run_batch, iteration = MTIP.run_batch, MTIP.mtip_iteration
    shrink_wrap = MTIP._shrink_wrap

    def spy_run(self, rho0, schedule):
        out = run_batch(self, rho0, schedule)
        own.append(out[1].cpu().numpy())
        return out

    def spy_iteration(self, rho_in, support, beta, method, ft_stab,
                      ft_gate=None):
        out = iteration(self, rho_in, support, beta, method, ft_stab,
                        ft_gate)
        k = next(calls)
        if k in PRECISION_THETA_STEPS:   # kept on the card until the end
            steps[k] = ((rho_in.clone(), support.clone()), float(beta),
                        method, bool(ft_stab), out[1].clone(),
                        out[2].clone())
        return out

    def spy_shrink_wrap(self, state, seg):
        out = shrink_wrap(self, state, seg)
        sws.append(((state.rho.clone(), state.support.clone()),
                    state.last_err.clone(), seg, out.support.clone()))
        return out
    MTIP.run_batch, MTIP.mtip_iteration = spy_run, spy_iteration
    MTIP._shrink_wrap = spy_shrink_wrap
    try:
        w = select_worker("fxs", "reconstruct", "tutorial",
                          overrides=overrides, device=mesh.device, mesh=mesh)
        res = w.run()
    finally:
        MTIP.run_batch, MTIP.mtip_iteration = run_batch, iteration
        MTIP._shrink_wrap = shrink_wrap
    exchanges = {k: dict(v) for k, v in mesh.exchanges.items()}

    def joined(*fields):
        """This rank's θ rows of ρ and the support, or of the support
        alone → on rank 0 the whole grid's (host arrays)."""
        keys = ("rho", "support")[-len(fields):]
        got = mesh.gather({k: v.cpu().numpy() for k, v in zip(keys, fields)},
                          name="steps", n_theta=n_theta)
        return None if got is None else tuple(got[k] for k in keys)

    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    joined_steps, sw_joined = {}, []
    for k in PRECISION_THETA_STEPS:
        state, *rest = steps.pop(k)
        state = joined(*state)
        if mesh.rank == 0:
            joined_steps[k] = state + tuple(host(v) for v in rest)
    for before, last_err, seg, after in sws:
        before, after = joined(*before), joined(after)
        if mesh.rank == 0:
            sw_joined.append(before + (host(last_err), seg) + after)
    errors = mesh.gather_objects(own)
    starts = mesh.gather_objects(started)
    if mesh.rank != 0:
        return None
    return (res, w.saved[0], errors, joined_steps, exchanges,
            w.rank_launches, starts, sw_joined)


def precision_theta(torch, np, inv_path, ref, devices=MESH_DEVICES):
    """Phase precision, run (vi): run (i)'s settings with mesh {restarts:
    1, theta: 2} over two ranks on `devices`, held against run (i)'s
    archive and errors (`ref`: run (i)'s seen and line): ρ0 bitwise, the
    first iteration within 1e-10 and the iterations after the
    shrink-wrap within 1e-6 where both final supports agree (relative,
    main and reciprocal columns; not compared where no support agrees);
    at PRECISION_THETA_STEPS one iteration of run (i)'s MTIP on one card
    from (vi)'s own state within 1e-10 of (vi)'s errors; run (i)'s
    shrink-wrap on one card from (vi)'s state before each shrink-wrap
    bitwise (vi)'s support after it; the two θ ranks' error series
    bitwise equal, the archive's layout (i)'s, no kernel launched, at
    most PRECISION_THETA_MAX_S seconds. → the line's launch counts."""
    from xframe_tpu_torch.parallel.mesh import make_mesh, run_ranks
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    from xframe_tpu_torch.projects.fxs.store import load_archive
    seen_i, line_i = ref
    rho0, state_i, errors_i = seen_i["run"]
    schedule, aux, mtip_i = seen_i["schedule"], seen_i["aux"], seen_i["mtip"]
    smi = nvidia_smi()
    overrides = options_overrides(inv_path, PRECISION_THETA)
    counts = {}
    t0 = time.perf_counter()
    with kernel_instances(counts):
        (res, saved, rank_errors, steps, exchanges, launches, starts,
         sws) = run_ranks(make_mesh(PRECISION_THETA["mesh"], devices),
                          precision_theta_rank, overrides,
                          int(rho0.shape[-2]), time.time())
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # one iteration of run (i)'s MTIP on one card from (vi)'s states (the
    # class's method: run (i)'s instance still carries its spies)
    step_rel = {}
    for k, (rho, sup, beta, method, ft_stab, err, err_rec) in steps.items():
        one = MTIP.mtip_iteration(
            mtip_i, torch.as_tensor(rho, device=rho0.device),
            torch.as_tensor(sup, device=rho0.device), beta, method, ft_stab)
        step_rel[k] = max(float((np.abs(o.cpu().numpy() - e)
                                 / np.maximum(np.abs(o.cpu().numpy()),
                                              1e-300)).max())
                          for o, e in ((one[1], err), (one[2], err_rec)))
    # run (i)'s shrink-wrap on one card from (vi)'s state before it
    sw_differ = []
    dev = rho0.device
    for rho, sup, last_err, seg, after in sws:
        state = mtip_i.initial_state_batch(torch.as_tensor(rho, device=dev),
                                           support=torch.as_tensor(
                                               sup, device=dev))
        one = MTIP._shrink_wrap(mtip_i, state._replace(
            last_err=torch.as_tensor(last_err, device=dev)), seg)
        sw_differ.append(int((one.support.cpu().numpy() != after).sum()))
    wall_steps = time.perf_counter() - t0
    sqrt_s = float(np.sqrt(aux["data_scale"]))
    rows = match_restarts(np, res["reconstruction_results"],
                          rho0.cpu().numpy(), sqrt_s, "precision (vi)")
    errors_i = errors_i.cpu().numpy()
    support_i = state_i.support.cpu().numpy()
    n_head = 0
    for seg in schedule:
        if seg.method in ("SW", "SW_center"):
            break
        n_head += int(seg.n) if seg.method in ("HIO", "ER", "RAAR") else 0
    first, after_sw = 0.0, None
    series = np.zeros(errors_i.shape[1])  # (vi)'s distance per iteration
    supports_agree = []
    for k, i in enumerate(rows):
        got = res["reconstruction_results"][str(k)]
        same = bool(np.array_equal(got["last_support_mask"], support_i[i]))
        supports_agree.append(same)
        for c, col in enumerate(("main", "reciprocal")):
            a, b = got["error_dict"][col], errors_i[i, :, c]
            r = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
            series = np.maximum(series, r)
            first = max(first, float(r[0]))
            if same:
                after_sw = max(after_sw or 0.0, float(r[n_head:].max()))
    ranks_bitwise = len(rank_errors) == 2 and all(
        len(e) == 1 for e in rank_errors) and np.array_equal(
            rank_errors[0][0], rank_errors[1][0])
    same_layout = archive_layout(np, load_archive(saved)) \
        == archive_layout(np, load_archive(seen_i["saved"]))
    all_launches = dict(counts)
    add_counts(all_launches, launches)
    n_iter = int(errors_i.shape[1])
    theta_ex = {k: v for k, v in exchanges.items() if k != "state"}
    timing = res["timing"]
    checks = {
        "first_iteration": first <= PRECISION_THETA_TOLS["first"],
        "one_card_steps": sorted(step_rel) == list(PRECISION_THETA_STEPS)
        and max(step_rel.values()) <= PRECISION_THETA_TOLS["first"],
        "shrink_wrap_one_card": len(sw_differ) > 0 and not any(sw_differ),
        "ranks_bitwise": bool(ranks_bitwise),
        "archive_layout": same_layout,
        "no_launches": not any(all_launches.values()),
        "finite": all(bool(np.isfinite(r["real_density"]).all())
                      for r in res["reconstruction_results"].values()),
        "seconds": wall_steps <= PRECISION_THETA_MAX_S}
    if after_sw is not None:       # some restart's supports agree with (i)
        checks["after_sw"] = after_sw <= PRECISION_THETA_TOLS["after_sw"]
    emit(phase="precision", run="(vi) float64 mesh.theta 2", card=smi,
         devices=[str(d) for d in devices], ranks=2, seconds=wall,
         seconds_with_steps=wall_steps, max_seconds=PRECISION_THETA_MAX_S,
         rank_start_seconds=starts, setup_s=timing["setup_s"],
         phasing_s=timing["phasing_s"],
         s_per_iteration_per_restart=timing["sec_per_iteration_per_restart"],
         run_i_s_per_iteration_per_restart=line_i[
             "s_per_iteration_per_restart"],
         iterations=n_iter, iterations_before_sw=n_head,
         restarts=len(rows), first_iteration_rel_to_run_i=first,
         after_sw_rel_to_run_i="not compared: no support agrees with "
         "run (i)'s" if after_sw is None else after_sw,
         tols=PRECISION_THETA_TOLS,
         supports_agree_with_run_i=supports_agree,
         shrink_wraps_one_card_points_differ=sw_differ,
         rel_to_run_i_every_10=series[::10].tolist(),
         one_card_step_rel=step_rel,
         exchange_bytes_per_iteration=sum(
             v["bytes"] for v in theta_ex.values()) / n_iter,
         exchange_seconds_per_iteration=sum(
             v["seconds"] for v in theta_ex.values()) / n_iter,
         exchange_wait_seconds_per_iteration=sum(
             v["wait_seconds"] for v in theta_ex.values()) / n_iter,
         exchanges=exchanges, rank_launches=launches, checks=checks,
         launches={k: v for k, v in all_launches.items() if v})
    check(all(checks.values()), f"precision (vi): checks failed: "
          f"{[k for k, v in checks.items() if not v]}")
    return all_launches


def phase_precision(torch, np, inv_path, ccd_path):
    """Phase precision, runs (i), (ii), (vi) and (v) (see the module
    docstring); (vi) is held against (i)'s own run, so no second reference
    runs. → their launch counts (all 0: no kernel lies on these
    paths)."""
    from xframe_tpu_torch.projects.fxs import simulate_ccd
    from xframe_tpu_torch.projects.fxs.store import load_npz
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    t_all = time.perf_counter()
    total = dict.fromkeys(counters(), 0)
    base = options_overrides(inv_path, {})
    run_i = None
    for name, extra in PRECISION_RUNS.items():
        overrides = options_overrides(inv_path, extra)
        seen, line, checks = precision_worker(torch, np, name, overrides)
        if name.startswith("(i)"):
            run_i = (seen, line)
        mtip, schedule, aux = seen["mtip"], seen["schedule"], seen["aux"]
        rho0, _, errors = seen["run"]
        t0 = time.perf_counter()
        # the default float32 kernel path (fused) from the same densities
        default = first_errors(card_mtip(base), rho0.to(torch.complex64),
                               schedule)
        if name.startswith("(i)"):
            _, cpu_mtip, _, _, _ = cpu_twin(overrides, aux)
            cpu, rel = first_iteration_vs_cpu(
                np, cpu_mtip, mtip.initial_state_batch(rho0), schedule, 0,
                errors)
            checks["first_iteration_vs_cpu"] = rel <= PRECISION_CPU_TOL
            line.update(first_iteration_vs_cpu=rel, tol=PRECISION_CPU_TOL,
                        card_errors=errors[:, 0].cpu().tolist(),
                        cpu_errors=cpu.tolist(),
                        float32_kernel_path_vs_float64=rel_distance(
                            np, default, errors[:, 0]),
                        float32_kernel_path_errors=default.cpu().tolist())
        else:
            stepwise_k = first_errors(card_mtip(base, fused=False), rho0,
                                      schedule)
            rel = rel_distance(np, errors[:, 0], stepwise_k)
            checks["first_iteration_vs_stepwise_kernels"] = \
                rel <= PRECISION_KERNEL_TOL
            line.update(first_iteration_vs_stepwise_kernels=rel,
                        tol=PRECISION_KERNEL_TOL,
                        card_errors=errors[:, 0].cpu().tolist(),
                        stepwise_kernel_errors=stepwise_k.cpu().tolist(),
                        fused_kernel_path_vs_plain=rel_distance(
                            np, default, errors[:, 0]))
        emit(phase="precision", checks=checks,
             check_seconds=time.perf_counter() - t0, **line)
        check(all(checks.values()), f"precision run {name}: checks failed: "
              f"{[k for k, v in checks.items() if not v]}")

    # (vi) run (i) over a θ mesh of two ranks on cuda:0, and on cuda:0,1
    # where the machine has two cards
    t0 = time.perf_counter()
    counts = precision_theta(torch, np, inv_path, run_i)
    for k in total:
        total[k] += counts.get(k, 0)
    if torch.cuda.device_count() > 1:
        counts = precision_theta(torch, np, inv_path, run_i,
                                 devices=["cuda:0", "cuda:1"])
        for k in total:
            total[k] += counts.get(k, 0)
    else:
        emit(phase="precision", run="(vi) float64 mesh.theta 2 on cuda:0,1",
             card=nvidia_smi(), not_run="the machine has one card")
    del run_i
    emit(phase="precision_theta_total", seconds=time.perf_counter() - t0)

    # (v) simulate_ccd on its tutorial settings on the plain transforms,
    # against the chain's kernel run
    seen = {}
    remove = spy_simulate(simulate_ccd, seen)
    try:
        w, res, counts, wall, peak = run_stage(
            torch, "simulate_ccd", "tutorial", overrides={
                "structure_name": "tutorial_plain",
                "fourier_transform": {"fused_sht": False},
                "IO": {"files": {"ccd": {"options": {
                    "save_model_vtk": False}}}}})
    finally:
        remove()
    plain = type(seen["ft"].harmonic) is SphericalHarmonicTransform
    del seen
    cc = res["cross_correlation"]["I1I1"]
    kernel_cc = load_npz(ccd_path)["cross_correlation"]["I1I1"]
    cc_diff = float(np.abs(cc - kernel_cc).max() / np.abs(kernel_cc).max())
    checks = {"no_launches": not any(counts.values()),
              "plain_transforms": plain, "cc": cc_diff <= PRECISION_CC_TOL}
    emit(phase="precision", run="(v) simulate_ccd fused_sht false",
         wall_seconds=wall, timing=res["timing"], max_memory_allocated=peak,
         cc_vs_kernels=cc_diff, tol=PRECISION_CC_TOL, checks=checks,
         launches={k: v for k, v in counts.items() if v})
    check(all(checks.values()), f"precision (v): checks failed: "
          f"{[k for k, v in checks.items() if not v]}")
    del res, cc, kernel_cc
    for k in total:
        total[k] += counts[k]
    emit(phase="precision_3d_total", seconds=time.perf_counter() - t_all)
    return total


def precision_2d(torch, np, inv_path):
    """Phase precision, run (iv): the 2D reconstruct worker on tutorial_2d
    in float64, 2 restarts, one cycle, its first iteration against the
    CPU's float64 run from the same densities."""
    overrides = {"input": {"invariants_path": inv_path},
                 "precision": "float64",
                 "multi_start": {"n_reconstructions": OPTIONS_RESTARTS,
                                 "batch_size": OPTIONS_RESTARTS, "seed": 0},
                 "main_loop": {"sub_loops": {"order": ["main"],
                                             "main": {"iterations": 1}}}}
    seen, line, checks = precision_worker(torch, np, "(iv) float64 2D",
                                          overrides, "tutorial_2d")
    t0 = time.perf_counter()
    rho0, _, errors = seen["run"]
    _, cpu_mtip, _, _, _ = cpu_twin(overrides, seen["aux"], "tutorial_2d")
    cpu, rel = first_iteration_vs_cpu(
        np, cpu_mtip, seen["mtip"].initial_state_batch(rho0),
        seen["schedule"], 0, errors)
    checks["first_iteration_vs_cpu"] = rel <= PRECISION_CPU_TOL
    emit(phase="precision", checks=checks, first_iteration_vs_cpu=rel,
         tol=PRECISION_CPU_TOL, card_errors=errors[:, 0].cpu().tolist(),
         cpu_errors=cpu.tolist(), check_seconds=time.perf_counter() - t0,
         **line)
    check(all(checks.values()), f"precision (iv): checks failed: "
          f"{[k for k, v in checks.items() if not v]}")


def precision_production(torch, np, host):
    """Phase precision, run (iii): the production problem in float64 under
    newton_schulz_pallas, on the float32 production problem's host grid
    and true density (`host`), 1 restart, PRECISION_PROD_ITERS HIO
    iterations and finalize: B7 three launches an iteration (c = 127, 253,
    255 on complex64 crops) and three in finalize, B8 none. The first
    iteration against the same with each crop through B7's plain version
    on the card; the distance to a float64 newton_schulz run printed. →
    the launch counts."""
    import dataclasses
    from xframe_tpu_torch.ops import fused_projection
    from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu_torch.projects.fxs import projections
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    t_all = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    with kernel_instances(counts):
        p = make_demo_problem(PROD["n_q"], PROD["l_max"],
                              n_theta=PROD["n_theta"], n_phi=PROD["n_phi"],
                              procrustes_method="newton_schulz_pallas",
                              ns_schedule=DEFAULT_SCHEDULE,
                              real_dtype=torch.float64, host=host,
                              device="cuda")
        torch.cuda.synchronize()
        setup = time.perf_counter() - t_all
        mtip, n = p.mtip, PRECISION_PROD_ITERS
        schedule = [Segment("HIO", n, betas=np.full(n, 0.5), ft_stab=True)]
        rho0 = p.initial_density_batch(0, PROD["restarts"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, errors = mtip.run_batch(rho0, schedule)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        psi_p, W = mtip.finalize(state.best_rho)
        torch.cuda.synchronize()
        finalize_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    buckets = len(projections.crop_buckets(PROD["l_max"]))
    checks = {
        "b7_launches": counts["polar_unitary"] == buckets * (n + 1),
        "b8_none": counts["fused_projection_bucket"] == 0,
        "no_sht_or_iteration_kernels": not any(
            v for k, v in counts.items()
            if k not in fused_projection.METHODS),
        "float64": state.rho.dtype == torch.complex128
        and W.dtype == torch.complex128 and not mtip.rc.k5_active,
        "finite": bool(torch.isfinite(errors).all())}
    del psi_p, W
    # each crop through B7's plain version (on the card, complex64), then
    # the plain float64 Newton–Schulz, from the same density
    inner = projections.polar_unitary
    projections.polar_unitary = \
        lambda m, it=16, schedule=None: \
        fused_projection.polar_unitary_newton_schulz(m, it,
                                                     schedule=schedule)
    try:
        plain_b7 = first_errors(mtip, rho0, schedule)
    finally:
        projections.polar_unitary = inner
    rel_b7 = rel_distance(np, errors[:, 0], plain_b7)
    checks["first_iteration_vs_plain_b7"] = rel_b7 <= PRECISION_B7_TOL
    ns64 = copy.copy(mtip)
    ns64.rc = dataclasses.replace(mtip.rc, procrustes_method="newton_schulz")
    rel_ns = rel_distance(np, errors[:, 0], first_errors(ns64, rho0,
                                                         schedule))
    emit(phase="precision", run="(iii) float64 production", checks=checks,
         setup_s=setup, phasing_s=run_s, finalize_s=finalize_s,
         iterations=n, s_per_iteration=run_s / n, max_memory_allocated=peak,
         first_iteration_vs_plain_b7=rel_b7, tol=PRECISION_B7_TOL,
         first_iteration_vs_newton_schulz_float64=rel_ns,
         errors=errors[:, :, 0].cpu().tolist(),
         launches={k: v for k, v in counts.items() if v},
         implied_b7=buckets * (n + 1),
         seconds=time.perf_counter() - t_all, **PROD)
    check(all(checks.values()), f"precision (iii): checks failed: "
          f"{[k for k, v in checks.items() if not v]}")
    return counts


def device_share(torch, fn):
    """Run fn() under torch.profiler. → (its result, wall seconds, the
    device's busy share: the CUDA kernels' and copies' summed time over
    the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    return out, wall, busy / wall


def chain_2d_line(stage, res, wall, peak, share, **extra):
    emit(phase="chain_2d", stage=stage, wall_seconds=wall,
         timing=res.get("timing") if isinstance(res, dict) else None,
         max_memory_allocated=peak, device_share=share, **extra)


def gram_diff(np, a_list, b_list):
    """max |a a† − b b†| over the orders / max |b b†|."""
    grams = [(a @ a.conj().T, b @ b.conj().T)
             for a, b in zip(a_list, b_list)]
    return max(float(np.abs(a - b).max()) for a, b in grams) \
        / max(float(np.abs(b).max()) for _, b in grams)


def phase_chain_2d(torch, np):
    """Phase 13: the 2D tutorial chain on the card through run_worker on
    the shipped tutorial_2d settings, uncut, in a temporary home; each
    stage against the port's CPU run; then the scale line."""
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.ops.integrate import PolarIntegrator
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    from xframe_tpu_torch.projects.fxs import simulate_ccd
    from xframe_tpu_torch.projects.fxs.fidelity import (
        align_batch_to_ground_truth, align_to_ground_truth)
    from xframe_tpu_torch.settings import load_settings
    t_all = time.perf_counter()
    with temporary_home():
        # simulate_ccd: the card's density kept for the CPU run
        seen = {}
        inner = simulate_ccd.device_density_from_shapes

        def spy(axes, opt, rng=None, device="cuda"):
            seen["axes"] = axes
            seen["density"] = inner(axes, opt, rng, device=device)
            return seen["density"]
        simulate_ccd.device_density_from_shapes = spy
        sim_shapes = load_settings("simulate_ccd", "tutorial_2d")["shapes"]
        torch.cuda.reset_peak_memory_stats()
        w = select_worker("fxs", "simulate_ccd", "tutorial_2d")
        try:
            sim, wall_run, share = device_share(torch, w.run)
        finally:
            simulate_ccd.device_density_from_shapes = inner
        peak = torch.cuda.max_memory_allocated()
        card_density = seen.pop("density").cpu()
        cc = sim["cross_correlation"]["I1I1"]
        check(cc.shape == (256, 256, 256) and bool(np.isfinite(cc).all()),
              f"chain_2d simulate: CC of shape {cc.shape}, or not finite")
        # the CPU run on the card's density; the CPU's own density builder
        # counted against it (they differ only where a point lies on a
        # shape's edge to float32 rounding)
        cpu_density = inner(seen["axes"], sim_shapes, device="cpu")
        disagree = int((cpu_density - card_density).abs().gt(1e-6).sum())
        simulate_ccd.device_density_from_shapes = \
            lambda axes, opt, rng=None, device="cuda": card_density
        try:
            t0 = time.perf_counter()
            cpu_sim = select_worker("fxs", "simulate_ccd", "tutorial_2d",
                                    {"structure_name": "tutorial_2d_cpu"},
                                    device="cpu").run()
            cpu_wall = time.perf_counter() - t0
        finally:
            simulate_ccd.device_density_from_shapes = inner
        cpu_cc = cpu_sim["cross_correlation"]["I1I1"]
        cc_diff = float(np.abs(cc - cpu_cc).max() / np.abs(cpu_cc).max())
        chain_2d_line("simulate_ccd", sim, wall_run, peak, share,
                      cc_shape=list(cc.shape), cpu_vs_card=cc_diff,
                      tol=CHAIN_2D_CC_TOL, cpu_seconds=cpu_wall,
                      density_points_differing_cpu=disagree,
                      density_points=int(card_density.numel()))
        check(cc_diff <= CHAIN_2D_CC_TOL, f"chain_2d simulate: the CPU's CC "
              f"departs from the card's by {cc_diff} of max")
        check(disagree <= 5e-3 * card_density.numel(),
              f"chain_2d simulate: the CPU's density builder disagrees "
              f"with the card's on {disagree} points")
        ccd_path = w.saved[0]
        del sim, cpu_sim, cc, cpu_cc

        # extract: the card's archive on both devices
        torch.cuda.reset_peak_memory_stats()
        w = select_worker("fxs", "extract", "tutorial_2d")
        inv, wall, share = device_share(torch, w.run)
        peak = torch.cuda.max_memory_allocated()
        inv_path = w.saved[0]
        t0 = time.perf_counter()
        cpu_inv = select_worker("fxs", "extract", "tutorial_2d",
                                {"input": {"ccd_path": ccd_path}},
                                device="cpu").run()
        cpu_wall = time.perf_counter() - t0
        g_diff = gram_diff(np, inv["data_projection_matrices"]["I1I1"],
                           cpu_inv["data_projection_matrices"]["I1I1"])
        bm = np.asarray(inv["deg_2_invariant"]["I1I1"])
        chain_2d_line("extract", inv, wall, peak, share,
                      orders=int(bm.shape[0]), cpu_vs_card_gram=g_diff,
                      tol=CHAIN_2D_GRAM_TOL, cpu_seconds=cpu_wall)
        check(g_diff <= CHAIN_2D_GRAM_TOL, f"chain_2d extract: the CPU's "
              f"V_m V_m† depart from the card's by {g_diff} of max")
        check(float(np.abs(bm[1::2]).max()) <= 1e-8 * float(np.abs(bm).max()),
              "chain_2d extract: odd orders not 0")
        del inv, cpu_inv, bm

        # reconstruct: chunk 0's first iteration against the CPU's on the
        # same initial densities
        w = select_worker("fxs", "reconstruct", "tutorial_2d")
        chunk0 = {}
        setup = w.setup_mtip

        def setup_mtip(inv):
            mtip, ft, aux = setup(inv)
            guess, run_batch = aux["initial_density_batch"], mtip.run_batch

            def first_guess(seed, n):
                rho0 = guess(seed, n)
                chunk0.setdefault("rho0", rho0.cpu())
                return rho0

            def first_run(rho0, schedule):
                out = run_batch(rho0, schedule)
                chunk0.setdefault("errors", out[1][:, 0].cpu())
                chunk0.setdefault("schedule", schedule)
                return out
            aux["initial_density_batch"] = first_guess
            mtip.run_batch = first_run
            chunk0["mtip"] = mtip
            return mtip, ft, aux
        w.setup_mtip = setup_mtip
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = w.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        cw = select_worker("fxs", "reconstruct", "tutorial_2d",
                           {"input": {"invariants_path": inv_path}},
                           device="cpu")
        cm, cft, _ = cw.setup_mtip(cw._load_invariants())
        first = chunk0["schedule"][0]
        _, cpu_err = cm.run_batch(chunk0["rho0"], [Segment(
            first.method, 1, betas=np.asarray(first.betas)[:1],
            ft_stab=first.ft_stab)])
        e_diff = float((cpu_err[:, 0] - chunk0["errors"]).abs().max())
        results = rec["reconstruction_results"]
        finals = [float(results[str(r)]["error_dict"]["final"])
                  for r in range(len(results))]
        chain_2d_line("reconstruct", rec, wall, peak, "not measured",
                      restarts=len(results), mtip=dict(
                          best_mode=chunk0["mtip"].best_mode,
                          so_pin_order=chunk0["mtip"].rc.so_pin_order,
                          fused=chunk0["mtip"]._fi is not None),
                      first_iteration_cpu_vs_card=e_diff,
                      tol=CHAIN_2D_ERR_TOL, final_errors=finals)
        check(e_diff <= CHAIN_2D_ERR_TOL, f"chain_2d reconstruct: chunk 0's "
              f"first-iteration errors depart from the CPU's by {e_diff}")
        for r, v in results.items():
            check(bool(np.isfinite(v["real_density"]).all()),
                  f"chain_2d reconstruct: restart {r} is not finite")

        torch.cuda.reset_peak_memory_stats()
        w = select_worker("fxs", "average", "tutorial_2d")
        avg, wall, share = device_share(torch, w.run)
        peak = torch.cuda.max_memory_allocated()
        chain_2d_line("average", avg, wall, peak, share,
                      aligned=len(avg["aligned"]))
        t0 = time.perf_counter()
        ft = w.ft
        weights = PolarIntegrator(ft.rs, ft.n_phi, device="cuda")._w
        corr = align_to_ground_truth(avg["average"]["real_density"],
                                     sim_shapes, ft, weights, dim=2)[0]
        corrs = align_batch_to_ground_truth(
            [results[str(r)]["real_density"] for r in range(len(results))],
            sim_shapes, ft, weights, dim=2)[0]
        emit(phase="chain_2d_fidelity", average_correlation=corr,
             best_correlation=corrs[0], restart_correlations=corrs,
             bounds={"best": CHAIN_2D_BEST_MIN,
                     "average": CHAIN_2D_AVERAGE_MIN},
             seconds=time.perf_counter() - t0)
        check(corrs[0] >= CHAIN_2D_BEST_MIN and corr >= CHAIN_2D_AVERAGE_MIN,
              f"chain_2d: ground-truth correlations {corrs[0]} (best), "
              f"{corr} (average) below {CHAIN_2D_BEST_MIN}, "
              f"{CHAIN_2D_AVERAGE_MIN}")
        del rec, avg
        phase_scale_2d(torch, np, inv_path)
        precision_2d(torch, np, inv_path)
    emit(phase="chain_2d_total", seconds=time.perf_counter() - t_all)


def phase_scale_2d(torch, np, inv_path):
    """One reconstruct batch at the simulate grid (N = 256, M = 64,
    n_phi = 256) from the chain's invariants: SCALE_2D restarts, HIO with
    ft-stab after 5 warm-up iterations; s/iteration/restart, peak memory,
    then the device's busy share over 10 more iterations."""
    from xframe_tpu_torch.main import select_worker
    from xframe_tpu_torch.projects.fxs.phasing import Segment
    w = select_worker("fxs", "reconstruct", "tutorial_2d", {
        "grid": {"n_radial_points": 256, "max_order": 64, "n_phi": 256},
        "input": {"invariants_path": inv_path}})
    mtip, ft, aux = w.setup_mtip(w._load_invariants())
    n, iters = SCALE_2D["restarts"], SCALE_2D["iterations"]

    def hio(k):
        return [Segment("HIO", k, betas=np.full(k, 0.5), ft_stab=True)]
    torch.cuda.reset_peak_memory_stats()
    state = mtip.initial_state_batch(aux["initial_density_batch"](0, n))
    state, _ = mtip.run_from(state, hio(5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, errors = mtip.run_from(state, hio(iters))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _, wall_p, share = device_share(torch, lambda: mtip.run_from(state,
                                                                 hio(10)))
    e = errors[..., 0].cpu().numpy()
    emit(phase="chain_2d_scale", grid=list(ft.grid_shape), m_max=ft.m_max,
         restarts=n, iterations=iters, seconds=wall,
         sec_per_iteration_per_restart=wall / (iters * n),
         max_memory_allocated=peak, device_share=share,
         profiled_seconds_per_iteration=wall_p / 10)
    check(bool(np.isfinite(e).all()), "chain_2d scale: non-finite errors")


# ------------------------------------------------------------------ cli
# phase cli: the port as users start it, in a fresh home. The home copies
# of the tutorial settings cut only depth (CLI_RESTARTS restarts, one
# short cycle); the grid and L stay the tutorial's full width
CLI_RESTARTS = 2
CLI_CYCLE = {"HIO": 30, "SW": 1, "ER": 20}
CLI_VTK_CAP = 1
# the kernels the reconstruct worker's trace must name (through LABELS)
CLI_TRACED = ("B1", "B3", "B4", "B5", "B6")
RUN_SNAPSHOT = ["settings.json", "settings_merged.json"]


def cli_subprocess(args, home):
    """python -m xframe_tpu_torch <args> from this checkout with
    XFRAME_TPU_HOME=home. → (its standard output, seconds)"""
    import os
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "xframe_tpu_torch", *args],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         env=dict(os.environ, XFRAME_TPU_HOME=home))
    check(out.returncode == 0, f"python -m xframe_tpu_torch {' '.join(args)}"
          f" exited {out.returncode}: {out.stderr[-3000:]}")
    return out.stdout, time.perf_counter() - t0


def cli_in_process(torch, args, counts):
    """xframe_tpu_torch.main.main(args) in this process, its kernel
    launches counted into `counts`. → seconds"""
    from xframe_tpu_torch.main import main
    t0 = time.perf_counter()
    with kernel_instances(counts):
        rc = main(list(args))
        torch.cuda.synchronize()
    check(rc == 0, f"main({args}) returned {rc}")
    return time.perf_counter() - t0


def edit_home_settings(home):
    """The home copies of reconstruct/ and average/tutorial.json: the
    reconstruct run cut to CLI_RESTARTS restarts and one cycle of
    CLI_CYCLE, traced (profiling.enable), its .vts capped at CLI_VTK_CAP;
    the average without average_density.vts, so that the outputs show the
    home copy won. → the reconstruct copy's text."""
    import os
    folder = os.path.join(home, "settings", "projects", "fxs")
    rec_path = os.path.join(folder, "reconstruct", "tutorial.json")
    with open(rec_path) as f:
        rec = json.load(f)
    rec["multi_start"] = {"n_reconstructions": CLI_RESTARTS,
                          "batch_size": CLI_RESTARTS, "seed": 0}
    rec["main_loop"] = {"sub_loops": {"order": ["main"], "main": {
        "iterations": 1, "order": list(CLI_CYCLE),
        "methods": {k: {"iterations": n} for k, n in CLI_CYCLE.items()}}}}
    rec["profiling"] = {"enable": True}
    rec["IO"] = {"files": {"reconstructions": {"options": {
        "generate_vtk_files": CLI_VTK_CAP}}}}
    avg_path = os.path.join(folder, "average", "tutorial.json")
    with open(avg_path) as f:
        avg = json.load(f)
    avg["IO"] = copy.deepcopy(NO_VTK["average"])
    for path, tree in ((rec_path, rec), (avg_path, avg)):
        with open(path, "w") as f:
            json.dump(tree, f, indent=1)
    with open(rec_path) as f:
        return f.read()


def cli_trace_kernels(home):
    """The hand kernels named in the reconstruct worker's trace under
    <home>/traces. → ({B-number: [labels]}, trace bytes, kernel events)"""
    import glob
    import os
    traces = glob.glob(os.path.join(home, "traces", "*.pt.trace.json"))
    check(len(traces) == 1, f"cli: {len(traces)} trace files, expected 1")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {}
    for name in sorted(set(kernels)):
        text = label(name)
        if text:
            found.setdefault(text.split()[0], []).append(text)
    return found, os.path.getsize(traces[0]), len(kernels)


def phase_cli(torch, np):
    """Phase cli: in a fresh XFRAME_TPU_HOME, `python -m xframe_tpu_torch
    --setup_home` and `--print_home` as subprocesses, the home copies of
    the reconstruct and average tutorial settings edited
    (edit_home_settings), `fxs simulate_ccd tutorial` once as a subprocess,
    then simulate_ccd, extract, reconstruct and average on the tutorial
    settings and `tutorial get_started` through main() in this process,
    their launches counted. Checks: each run folder holds exactly the
    archive, the settings snapshot and the .vts its settings ask for, and
    the two latest-run links point at the newest runs; the reconstruct
    run's snapshot is the home copy's text; real_density_0.vts decodes to
    the archive's real_density bitwise; the trace names B1, B3, B4, B5 and
    B6; get_started launches B1. → the launch counts."""
    import os
    from xframe_tpu_torch.io.vtk import read_field
    t_phase = time.perf_counter()
    total = dict.fromkeys(counters(), 0)
    stages, stage_launches = {}, {}
    with temporary_home() as home:
        _, stages["setup_home"] = cli_subprocess(["--setup_home"], home)
        printed, stages["print_home"] = cli_subprocess(["--print_home"],
                                                       home)
        check(printed.strip() == home, f"--print_home printed {printed!r}")
        rec_text = edit_home_settings(home)
        _, stages["simulate_ccd_subprocess"] = cli_subprocess(
            ["fxs", "simulate_ccd", "tutorial"], home)
        for project, worker in (("fxs", "simulate_ccd"), ("fxs", "extract"),
                                ("fxs", "reconstruct"), ("fxs", "average"),
                                ("tutorial", "get_started")):
            counts = {}
            args = ["--device", "cuda", project, worker]
            stages[worker] = cli_in_process(
                torch, args + (["tutorial"] if project == "fxs" else []),
                counts)
            stage_launches[worker] = {k: v for k, v in counts.items() if v}
            for k in total:
                total[k] += counts[k]
        check(stage_launches["get_started"].get("forward", 0) > 0,
              "cli: tutorial get_started launched no B1 (sht_forward)")
        t0 = time.perf_counter()
        data = os.path.join(home, "data", "fxs")
        runs = {"ccd/tutorial/run_1": ["ccd.npz", "model_density.vts"],
                "ccd/tutorial/run_2": ["ccd.npz", "model_density.vts"],
                "invariants/tutorial/run_1": ["proj_data.npz"],
                "reconstructions/tutorial/run_1": [
                    "data.npz"] + [f"real_density_{i}.vts"
                                   for i in range(CLI_VTK_CAP)],
                "averages/tutorial/run_1": ["average_results.npz"]}
        files = {}
        for run, want in runs.items():
            files[run] = sorted(os.listdir(os.path.join(data, run)))
            check(files[run] == sorted(want + RUN_SNAPSHOT),
                  f"cli: {run} holds {files[run]}")
        links = {}
        for link, target in (("ccd/tutorial/ccd.npz", "run_2/ccd.npz"),
                             ("invariants/tutorial/proj_data.npz",
                              "run_1/proj_data.npz")):
            links[link] = os.readlink(os.path.join(data, link))
            check(links[link] == target, f"cli: {link} -> {links[link]}")
        tut = sorted(os.listdir(os.path.join(home, "data", "tutorial",
                                             "run_1")))
        check(tut == ["result.npz"], f"cli: get_started wrote {tut}")
        rec = os.path.join(data, "reconstructions/tutorial/run_1")
        with open(os.path.join(rec, "settings.json")) as f:
            check(f.read() == rec_text, "cli: the reconstruct run's "
                  "settings.json is not the home copy's text")
        with open(os.path.join(rec, "settings_merged.json")) as f:
            merged = json.load(f)
        check(merged["profiling"]["enable"] is True
              and merged["multi_start"]["n_reconstructions"] == CLI_RESTARTS,
              "cli: the merged snapshot lacks the home copy's edits")
        with np.load(os.path.join(rec, "data.npz")) as d:
            rho = d["reconstruction_results/0/real_density"]
        # a complex density is written as density_real and density_imag,
        # the φ seam closed by a copy of the first column
        vts = os.path.join(rec, "real_density_0.vts")
        parts = ((("density_real", rho.real), ("density_imag", rho.imag))
                 if np.iscomplexobj(rho) else (("density", rho),))
        vts_bitwise = True
        for name, want in parts:
            back = read_field(vts, name).reshape(
                rho.shape[:-1] + (rho.shape[-1] + 1,), order="F")[..., :-1]
            vts_bitwise &= back.dtype == want.dtype and \
                bool(np.array_equal(back, want))
        check(bool(np.isfinite(rho).all()), "cli: real_density not finite")
        check(vts_bitwise, "cli: real_density_0.vts does not decode to the "
              "archive's real_density")
        found, trace_bytes, n_kernels = cli_trace_kernels(home)
        missing = [b for b in CLI_TRACED if b not in found]
        check(not missing, f"cli: the trace names no kernel of {missing}")
        stages["checks"] = time.perf_counter() - t0
    emit(phase="cli", seconds=time.perf_counter() - t_phase, stages=stages,
         launches=stage_launches, files=files, links=links,
         vts_bitwise=bool(vts_bitwise), vts_shape=list(rho.shape),
         vts_dtype=str(rho.dtype),
         trace_bytes=trace_bytes, trace_kernel_events=n_kernels,
         trace_kernels={b: found[b] for b in sorted(found)},
         get_started_b1=stage_launches["get_started"].get("forward", 0))
    return total


# extract_options' prephasing, 1 × 10 round trips, and low-resolution
# optimization, 10 round trips: the settings' 10 × 10 and 100 cut in
# depth, to make room for phase mesh
EXTRACT_PREPHASE, EXTRACT_LOW_RES = 1, 10


def phase_extract_options(torch, np, ccd_path):
    """Extract on the tutorial simulate_ccd archive with the options for
    experimental data: prephasing (EXTRACT_PREPHASE × 10 round trips),
    the optimized (EXTRACT_LOW_RES round trips)
    low-resolution coefficients (max_order 8) and the particle-number
    estimate, on the card and on the CPU. Checks: B2 launched once per
    round trip plus once for the estimate, B9 once per round trip, nothing
    else; V_l V_l† and the low-resolution V_l V_l† of the card within
    CHAIN_CPU_TOL of max of the CPU's; the convergence flags and the
    iteration counts equal; n_particles within one scale step. → the
    card's launch counts."""
    import os
    ov = {"structure_name": "tutorial_options",
          "input": {"ccd_path": ccd_path},
          "projection_matrices": {"prephase": {
              "apply": True, "iterations": EXTRACT_PREPHASE}},
          "low_resolution_intensity_approximation": {
              "max_order": 8, "n_iterations": EXTRACT_LOW_RES},
          "optimize_projection_matrices": {"use": True},
          "number_of_particles": {"estimate": {"apply": True}}}
    w, card, counts, wall, peak = run_stage(torch, "extract", "tutorial", ov)
    t0 = time.perf_counter()
    cpu = run_stage(torch, "extract", "tutorial", ov, device="cpu")[1]
    cpu_s = time.perf_counter() - t0
    runs, runs_cpu = card["sht_constraint"], cpu["sht_constraint"]
    trips = runs["prephase"]["iterations"] \
        + runs["low_resolution"]["iterations"]
    implied = dict.fromkeys(counters(), 0)
    implied.update(inverse=trips + 1, forward_real=trips)

    def gram_diff(a_list, b_list):
        return max(float(np.abs(a @ a.conj().T - b @ b.conj().T).max()
                         / max(np.abs(b @ b.conj().T).max(), 1e-300))
                   for a, b in zip(a_list, b_list))
    lr_card = card["data_low_resolution_intensity_coefficients"]
    lr_cpu = cpu["data_low_resolution_intensity_coefficients"]
    keys = sorted(lr_cpu, key=int)
    gram = gram_diff(card["data_projection_matrices"]["I1I1"],
                     cpu["data_projection_matrices"]["I1I1"])
    gram_lr = gram_diff([lr_card[k] for k in keys], [lr_cpu[k] for k in keys])
    scales = runs["number_of_particles"]["scales"]
    step = float(scales[1] - scales[0])
    n_card, n_cpu = card["number_of_particles"], cpu["number_of_particles"]
    emit(phase="extract_options", wall_seconds=wall, cpu_seconds=cpu_s,
         timing=card["timing"], saved_bytes=os.path.getsize(w.saved[0]),
         max_memory_allocated=peak,
         launches={k: v for k, v in counts.items() if v}, implied={
             k: v for k, v in implied.items() if v},
         prephase=runs["prephase"], prephase_cpu=runs_cpu["prephase"],
         low_resolution=runs["low_resolution"],
         low_resolution_cpu=runs_cpu["low_resolution"],
         n_particles=n_card, n_particles_cpu=n_cpu, scale_step=step,
         negative_fractions=[float(v) for v in
                             runs["number_of_particles"]
                             ["negative_fractions"]],
         cpu_vs_card_gram=gram, cpu_vs_card_low_resolution_gram=gram_lr,
         tol=CHAIN_CPU_TOL)
    check(counts == implied, f"extract_options: launch counts {counts} "
          f"differ from implied {implied}")
    for key in ("prephase", "low_resolution"):
        check(runs[key] == runs_cpu[key], f"extract_options: {key} on the "
              f"card {runs[key]}, on the CPU {runs_cpu[key]}")
    check(gram <= CHAIN_CPU_TOL and gram_lr <= CHAIN_CPU_TOL,
          f"extract_options: V_l V_l† of the card depart from the CPU's by "
          f"{gram} (low resolution {gram_lr}) of max")
    check(abs(np.sqrt(n_card) - np.sqrt(n_cpu)) <= step + 1e-12,
          f"extract_options: n_particles {n_card} on the card, {n_cpu} on "
          "the CPU")
    return counts


# ------------------------------------------------------------ correlate
# the correlate phase's frames: e(r)·(1 + a·cos 2(φ − φ_k))·(1 + σ·noise),
# NaN pixels per frame, dead (zero) pixels, unreadable and short files
FRAME_A, FRAME_SIGMA, FRAME_NANS, FRAME_DEAD = 0.5, 0.05, 20, 12
REF_FRAMES, REF_TOL = 128, 1e-4    # the float64 reference: frames, of max
RATIO_TOL = 1e-2                   # the cos 2Δ amplitude against a²/2
PANEL_SHAPE, PANEL_FRAMES, PANEL_BATCH = (128, 512), 256, 32
# the card against the CPU, of max: where few bin pairs overlap at a Δ
# (ccm ≈ 32 of 14784 at the AGIPD gaps) the mask-CCF division lifts the
# float32 rounding of the irfft, and either side departs from a float64
# run by 2.3e-5 of max
PANEL_TOL = 1e-4


def write_tutorial_frames(np, folder, opt, n_frames, seed):
    """Write the correlate tutorial's frames (opt: its settings) as .raw
    float32 files and their list. → (paths, the indices of the files left
    unreadable or short, the dead pixels' (y, x))."""
    import os
    rng = np.random.default_rng(seed)
    ny, nx = [int(v) for v in opt["image_dimensions"]]
    oy, ox = [float(v) for v in opt["detector_origin"]]
    y, x = np.mgrid[0:ny, 0:nx]
    r = np.hypot(y - oy, x - ox)
    phi = np.arctan2(y - oy, x - ox)
    envelope = ((1 + 4 * np.exp(-(r / 90) ** 2)) * np.exp(-r / 400)
                ).astype(np.float32)
    c2 = (envelope * np.cos(2 * phi)).astype(np.float32)
    s2 = (envelope * np.sin(2 * phi)).astype(np.float32)
    dead = (rng.integers(0, ny, FRAME_DEAD), rng.integers(0, nx, FRAME_DEAD))
    bad = {7: "missing", 100: "short"}
    for i in rng.choice(np.arange(REF_FRAMES, n_frames), 3, replace=False):
        bad[int(i)] = "missing" if len(bad) % 2 else "short"
    paths = [os.path.join(folder, f"frame_{i:05d}.raw")
             for i in range(n_frames)]
    for lo in range(0, n_frames, 64):
        n = min(64, n_frames - lo)
        ang = rng.uniform(0, np.pi, n).astype(np.float32)
        frames = envelope + FRAME_A * (np.cos(2 * ang)[:, None, None] * c2
                                       + np.sin(2 * ang)[:, None, None] * s2)
        frames *= 1 + FRAME_SIGMA * rng.standard_normal(
            frames.shape, dtype=np.float32)
        for k in range(n):
            frames[k][rng.integers(0, ny, FRAME_NANS),
                      rng.integers(0, nx, FRAME_NANS)] = np.nan
        frames[:, dead[0], dead[1]] = 0.0
        for k in range(n):
            kind = bad.get(lo + k)
            if kind == "short":
                with open(paths[lo + k], "wb") as f:
                    f.write(frames[k].tobytes()[: 4 * nx])
            elif kind is None:
                frames[k].tofile(paths[lo + k])
    with open(os.path.join(folder, "patterns_list.txt"), "w") as f:
        f.write("\n".join(os.path.basename(p) for p in paths))
    return paths, sorted(bad), dead


def reference_cc(np, corr, paths):
    """The CC of the frames at `paths` by plain float64 numpy and scipy, on
    the Correlator's sample points and grid (order 1, cval 0; validity
    regridded and > 0.99; no corrections or filters; the mask-CCF
    normalization; the fc_n_max low-pass). → (CC, good frames)."""
    from scipy.ndimage import map_coordinates
    ny, nx = corr.image_shape
    coords = corr._coords.astype(np.float64)
    polars, masks = [], []
    for path in paths:
        try:
            frame = np.fromfile(path, dtype=np.float32)
        except OSError:
            continue
        if frame.size != ny * nx:
            continue
        frame = frame.reshape(ny, nx).astype(np.float64)
        valid = np.isfinite(frame)
        pm = map_coordinates(valid.astype(np.float64), coords, order=1,
                             cval=0.0) > 0.99
        polars.append(map_coordinates(np.where(valid, frame, 0.0), coords,
                                      order=1, cval=0.0) * pm)
        masks.append(pm.astype(np.float64))

    def ccf(stack):
        f = np.ascontiguousarray(
            np.fft.rfft(np.stack(stack), axis=-1).transpose(2, 1, 0))
        out = np.matmul(f.conj(), np.ascontiguousarray(f.transpose(0, 2, 1)))
        return np.fft.irfft(out.transpose(1, 2, 0), corr.n_phi, axis=-1)
    cf, cm = ccf(polars), ccf(masks)
    cc = np.where(cm > 0.5, cf / np.where(cm > 0.5, cm, 1.0), 0.0)
    spec = np.fft.rfft(cc, axis=-1)
    spec[..., corr.fc_n_max + 1:] = 0
    return np.fft.irfft(spec, corr.n_phi, axis=-1), len(polars)


def harmonic_ratio(np, cc, dead, corr, opt):
    """2|F_2|/F_0 of the CC over Δ per ring pair, for the pairs whose rings
    are at least 2 apart, from ring 16 on, and pass no dead pixel (within
    2 pixels): C = e(q1)e(q2)(1 + a²/2·cos 2Δ) makes it a²/2. → (ratios,
    rings left out)."""
    oy, ox = [float(v) for v in opt["detector_origin"]]
    r_max = min(oy, ox, corr.image_shape[0] - 1 - oy,
                corr.image_shape[1] - 1 - ox)
    r_ring = (np.arange(corr.n_q) + 0.5) * r_max / corr.n_q
    r_dead = np.hypot(dead[0] - oy, dead[1] - ox)
    hit = (np.abs(r_ring[:, None] - r_dead[None, :]) < 2).any(axis=1)
    rings = np.nonzero((np.arange(corr.n_q) >= 16) & ~hit)[0]
    spec = np.fft.rfft(cc[np.ix_(rings, rings)], axis=-1)
    ratio = 2 * np.abs(spec[..., 2]) / spec[..., 0].real
    apart = np.abs(rings[:, None] - rings[None, :]) >= 2
    return ratio[apart], int(hit.sum())


def phase_correlate(torch, np, seed):
    """The correlate worker on its tutorial settings (tutorial-1a: 2000
    frames of 512×512, n_q 255, n_φ 1024, batch 64) on the card, from
    frames written into a temporary input folder; then extract on its
    archive. Checks: the CC finite and C(q1,q2,Δ) = C(q2,q1,−Δ) within
    REF_TOL of max; num_images_good the frames left good; the first
    REF_FRAMES frames through the card's Correlator within REF_TOL of max
    of the float64 reference; the cos 2Δ amplitude a²/2 within RATIO_TOL;
    extract's B_l finite and PSD."""
    import os
    from xframe_tpu_torch.native import PrefetchingFrameLoader
    from xframe_tpu_torch.projects.fxs.correlate import Correlator
    from xframe_tpu_torch.settings import load_settings
    opt = load_settings("correlate", "tutorial")
    n_frames = int(opt["max_n_patterns"])
    t_phase = time.perf_counter()
    with temporary_home() as home:
        folder = os.path.join(home, "frames")
        os.makedirs(folder)
        t0 = time.perf_counter()
        paths, bad, dead = write_tutorial_frames(np, folder, opt, n_frames,
                                                 seed)
        write_s = time.perf_counter() - t0
        w, res, _, wall, peak = run_stage(
            torch, "correlate", "tutorial",
            {"input": {"input_folder": folder}})
        timing = res["timing"]
        cc = res["cross_correlation"]["I1I1"]
        emit(phase="correlate", wall_seconds=wall, write_seconds=write_s,
             frames=n_frames, bad_files=bad, timing=timing,
             frames_per_second=n_frames / timing["loop_s"],
             saved_bytes=os.path.getsize(w.saved[0]),
             max_memory_allocated=peak, cc_shape=list(cc.shape),
             num_images_good=res["num_images_good"])
        check(bool(np.isfinite(cc).all()), "correlate: non-finite CC")
        mirror = np.roll(cc.transpose(1, 0, 2)[..., ::-1], 1, axis=-1)
        sym = float(np.abs(cc - mirror).max() / np.abs(cc).max())
        check(res["num_images_good"] == n_frames - len(bad),
              f"correlate: {res['num_images_good']} good frames, not "
              f"{n_frames - len(bad)}")

        t0 = time.perf_counter()
        grid = opt["polar_grid"]
        corr = Correlator(
            opt["image_dimensions"], opt["detector_origin"],
            opt["pixel_size"], opt["sample_distance"], opt["wavelength"],
            n_phi=grid["n_phi"], n_q=grid["n_q"],
            interpolation_order=opt["interpolation_order"],
            fc_n_max=opt["fc_n_max"], device="cuda")
        batch = int(opt["batch_size"])
        got = corr.correlate_frames(PrefetchingFrameLoader(
            paths[:REF_FRAMES], opt["image_dimensions"], batch_size=batch,
            buffers=corr.pinned_buffers(batch)))
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, n_ref = reference_cc(np, corr, paths[:REF_FRAMES])
        ref_err = float(np.abs(got["cross_correlation"] - want).max()
                        / np.abs(want).max())
        ratio, rings_out = harmonic_ratio(np, cc, dead, corr, opt)
        dev = np.abs(ratio / (FRAME_A ** 2 / 2) - 1)
        emit(phase="correlate_checks", symmetry_err=sym, ref_frames=n_ref,
             ref_good=got["num_images_good"], ref_err=ref_err, tol=REF_TOL,
             card_seconds=card_s, reference_seconds=time.perf_counter() - t0,
             ratio_pairs=int(ratio.size), ratio_rings_left_out=rings_out,
             ratio_median=float(np.median(ratio)),
             ratio_dev_max=float(dev.max()),
             ratio_dev_median=float(np.median(dev)), ratio_tol=RATIO_TOL)
        check(sym <= REF_TOL, f"correlate: C(q1,q2,Δ) departs from "
              f"C(q2,q1,−Δ) by {sym} of max")
        check(got["num_images_good"] == n_ref, "correlate: the reference "
              f"reads {n_ref} good frames, the card {got['num_images_good']}")
        check(ref_err <= REF_TOL, f"correlate: the card's CC departs from "
              f"the float64 reference by {ref_err} of max")
        check(float(dev.max()) <= RATIO_TOL, f"correlate: the cos 2Δ "
              f"amplitude departs from a²/2 by up to {float(dev.max())}")
        del cc, res, got, want
        w, inv, _, wall, peak = run_stage(torch, "extract", "tutorial", {
            "structure_name": "correlate_tutorial",
            "input": {"ccd_path": w.saved[0]}})
        bl = torch.as_tensor(inv["deg_2_invariant"]["I1I1"], device="cuda")
        least = []
        for l in range(0, bl.shape[0], 2):
            lam = torch.linalg.eigvalsh((bl[l] + bl[l].conj().T) / 2)
            least.append(float(lam.min() / max(float(lam.max()), 1e-300)))
        emit(phase="correlate_extract", wall_seconds=wall,
             timing=inv["timing"], max_memory_allocated=peak,
             least_eigenvalue_ratio=min(least))
        check(bool(torch.isfinite(torch.view_as_real(bl)).all()),
              "correlate: extract's B_l not finite")
        check(min(least) >= -1e-6, f"correlate: extract's B_l not PSD "
              f"({min(least)})")
    emit(phase="correlate_total", seconds=time.perf_counter() - t_phase)


def panel_frames(np, grid, n_frames, batch, seed):
    """Frames on a detector's scattering grid (q, θ, φ per pixel):
    e(q)·(1 + a·cos 2(φ − φ_k))·(1 + σ·noise), in (batch, ok) pairs."""
    rng = np.random.default_rng(seed)
    q, phi = grid[..., 0], grid[..., 2]
    e = np.exp(-q / 0.5).astype(np.float32)
    c2 = (e * np.cos(2 * phi)).astype(np.float32)
    s2 = (e * np.sin(2 * phi)).astype(np.float32)
    for lo in range(0, n_frames, batch):
        ang = rng.uniform(0, np.pi, batch).astype(np.float32)
        frames = e + FRAME_A * (np.cos(2 * ang)[:, None, None, None] * c2
                                + np.sin(2 * ang)[:, None, None, None] * s2)
        frames *= 1 + FRAME_SIGMA * rng.standard_normal(frames.shape,
                                                        dtype=np.float32)
        yield frames, np.ones(batch, dtype=np.float32)


def phase_panel(torch, np, seed):
    """PanelCorrelator on the nominal AGIPD-1M geometry (1,048,576 pixels,
    n_q 128, n_φ 512), PANEL_FRAMES frames in batches of PANEL_BATCH on the
    card; the first batch also on the CPU: within PANEL_TOL of max."""
    from xframe_tpu_torch.experiments.SPB.detectors.agipd import AGIPD
    from xframe_tpu_torch.projects.fxs.correlate import PanelCorrelator
    t0 = time.perf_counter()
    grid = AGIPD(detector_distance=0.217).pixel_grid_reciprocal(1.23984)
    n_q, n_phi = PANEL_SHAPE
    card = PanelCorrelator(grid, n_q, n_phi, device="cuda")
    table_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = card.correlate_frames(panel_frames(np, grid, PANEL_FRAMES,
                                             PANEL_BATCH, seed))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    first = next(panel_frames(np, grid, PANEL_BATCH, PANEL_BATCH, seed))
    got = card.correlate_frames(iter([first]))
    t0 = time.perf_counter()
    want = PanelCorrelator(grid, n_q, n_phi, device="cpu").correlate_frames(
        iter([first]))
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(got["cross_correlation"] - want["cross_correlation"])
                .max() / np.abs(want["cross_correlation"]).max())
    emit(phase="panel", pixels=int(card.n_pixels), n_q=n_q, n_phi=n_phi,
         frames=PANEL_FRAMES, batch=PANEL_BATCH,
         max_pixels_per_bin=int(card._max_count),
         gather_bytes=card.gather_bytes(PANEL_BATCH), table_seconds=table_s,
         wall_seconds=wall, timing=out["timing"],
         frames_per_second=PANEL_FRAMES / wall, max_memory_allocated=peak,
         num_images_good=out["num_images_good"], cpu_seconds=cpu_s,
         cpu_vs_card=err, tol=PANEL_TOL)
    check(bool(np.isfinite(out["cross_correlation"]).all()),
          "panel: non-finite CC")
    check(out["num_images_good"] == PANEL_FRAMES, "panel: good frames "
          f"{out['num_images_good']}")
    check(err <= PANEL_TOL, f"panel: the card departs from the CPU by {err} "
          "of max")


def production_problem():
    """The production problem on the card: make_demo_problem(256, 127,
    320×640, newton_schulz_pallas with the minimax schedule), the fused
    iteration with the fused projection."""
    from xframe_tpu_torch.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
    return make_demo_problem(PROD["n_q"], PROD["l_max"],
                             n_theta=PROD["n_theta"], n_phi=PROD["n_phi"],
                             procrustes_method="newton_schulz_pallas",
                             ns_schedule=DEFAULT_SCHEDULE, device="cuda")


def phase_production(torch, np):
    """Phase 16: the production cell with the fused projection, 1 restart,
    the 600-iteration tutorial schedule, then finalize; the variants and
    replay over the short schedule; the best density's ground-truth
    correlation (printed, not gated). → (launch counts, the problem's host
    grid and true density for precision_production)."""
    from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth
    from xframe_tpu_torch.projects.fxs.phasing import Segment

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = production_problem()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    rc = p.mtip.rc
    check(p.mtip._fi is not None and rc.k5_active and len(rc._k5) == 3,
          "the production problem does not run the fused projection in "
          "three buckets")
    emit(phase="production_problem", seconds=setup, **PROD)
    schedule = tutorial_schedule(Segment, np, p.mtip.sw.default_sigma)
    launches = {}
    launches["production"], _, (psi_p, W), _, state = run_slice(
        torch, np, p, p.mtip, "production", schedule, PROD["restarts"],
        finalize=True)
    # W is the identity outside each order's window [L − l, L + l], for
    # every order that carries data (V_l ≠ 0); an order without data has
    # B_l = 0, an unconverged W_l of scale 1e-20 and no use
    L, n_m = PROD["l_max"], 2 * PROD["l_max"] + 1
    idx = torch.arange(n_m, device="cuda")
    inside = (idx[None, :] - L).abs() <= torch.arange(L + 1,
                                                       device="cuda")[:, None]
    outside = ~(inside[:, :, None] & inside[:, None, :])
    eye = torch.eye(n_m, dtype=W.dtype, device="cuda")
    data = rc.V_pad.abs().amax((-2, -1)) > 0
    w_err = float(((W - eye).abs() * outside)[..., data, :, :].max())
    emit(phase="production_finalize", psi_p_shape=list(psi_p.shape),
         W_shape=list(W.shape), orders_with_data=int(data.sum()),
         W_outside_window_max_dev=w_err,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    check(w_err < 1e-5, f"finalize W departs from the identity outside the "
          f"windows by {w_err}")
    del psi_p, W

    # the variants against the default fused path on the production cell:
    # B4 against B11 + B1 (k2_fwd=False), B6 + B3 against B12 (k1_abs2=True),
    # 100 iterations each from the same density
    short = short_schedule(Segment, np, p.mtip.sw.default_sigma)
    first, per_iter = {}, {}
    for path, mtip in (("production_short", p.mtip),
                       ("production_k2_fwd", variant(p, k2_fwd=False)),
                       ("production_k1_abs2", variant(p, k1_abs2=True))):
        run = run_slice(torch, np, p, mtip, path, short, PROD["restarts"])
        launches[path], e, per_iter[path] = run[0], run[1], run[3]
        first[path] = e[:, 0]
        if path == "production_short":
            eager_short = run
    for path, what in (("production_k2_fwd", "k2_fwd=False"),
                       ("production_k1_abs2", "k1_abs2=True")):
        rel = np.abs(first[path] - first["production_short"]) \
            / np.abs(first["production_short"])
        emit(phase=f"{path}_vs_default", rel_first_iteration=rel.tolist(),
             s_per_iteration_per_restart={
                 k: per_iter[k] for k in ("production_short", path)})
        check(rel.max() < 1e-4, f"production {what} and default "
              f"first-iteration errors differ by {rel.max()}")
    launches["production_replay"] = phase_replay(
        torch, np, p, "production_replay", short, PROD["restarts"],
        eager_short)[0]
    del eager_short

    t0 = time.perf_counter()
    corr, _, _, info = align_to_ground_truth(
        state.best_rho[0], p.shapes, p.ft, p.integrator.w_broadcast)
    emit(phase="fidelity_production", correlation=corr,
         angles=info["angles"], inverted=info["inverted"],
         best_err=float(state.best_err[0]),
         seconds=time.perf_counter() - t0)
    launches["mesh_production"] = phase_mesh_production(torch, np, p)
    return launches, SimpleNamespace(grid=p.grid, rho_true=p.rho_true,
                                     shapes=p.shapes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-shapes", choices=sorted(KERNEL_SHAPES),
                    default="tutorial")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the correlate and panel phases' frames")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xframe_tpu_torch.ops import _build

    t0 = time.perf_counter()
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", seconds=time.perf_counter() - t0, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         h5py=importlib.util.find_spec("h5py") is not None,
         matplotlib=importlib.util.find_spec("matplotlib") is not None)

    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.library()
    emit(phase="build", seconds=time.perf_counter() - t0, nvcc_seconds=nvcc_s,
         library=path.name)

    t0 = time.perf_counter()
    results = phase_kernels(torch, np, args.kernel_shapes)
    emit(phase="kernels", seconds=time.perf_counter() - t0)
    if args.kernel_shapes != "tutorial":
        print(smi, flush=True)
        return 0

    t0 = time.perf_counter()
    phase_small(torch, np)
    launches = phase_slice(torch, np)
    launches.update(phase_chain(torch, np))
    phase_chain_2d(torch, np)
    launches["cli"] = phase_cli(torch, np)
    phase_correlate(torch, np, args.seed)
    phase_panel(torch, np, args.seed)
    production, host = phase_production(torch, np)
    launches.update(production)
    launches["precision_production"] = precision_production(torch, np, host)
    del host
    emit(phase="slices", seconds=time.perf_counter() - t0)

    emit(kernels=[dict(name=name, route="cuda", source=source,
                       replaces=where, launches=launches[path][counter]
                       + launches["chain"][counter]
                       + launches["extract_options"][counter]
                       + launches["options"][counter]
                       + launches["precision"][counter]
                       + launches["precision_production"][counter]
                       + launches["cli"][counter]
                       + launches["mesh"].get(counter, 0)
                       + launches["mesh_production"].get(counter, 0),
                       max_abs_err=results[name]["max_abs_err"],
                       ms=results[name]["ms"],
                       plain_ms=results[name]["plain_ms"],
                       bound_ms=results[name]["bound_ms"],
                       bound_by=results[name]["bound_by"],
                       library_ms=None)
                  for name, counter, path, source, where in KERNELS]
         + [dict(name=name, route="cuda", source=source, replaces=where,
                 launches=launches[path][counter],
                 max_abs_err=results[name]["max_abs_err"],
                 ms=results[name]["ms"], plain_ms=results[name]["plain_ms"],
                 bound_ms=results[name]["bound_ms"],
                 bound_by=results[name]["bound_by"], library_ms=None)
            for name, counter, path, source, where in BF16_KERNELS])
    for name, counter, path, _, _ in KERNELS + BF16_KERNELS:
        check(launches[path][counter] > 0,
              f"{name} was not launched on its path ({path})")
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
