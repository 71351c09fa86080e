#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card, ``nvcc`` and PyTorch built for CUDA.  It imports no
JAX.  Phases, each printing one JSON line to stdout:

1. device: requires CUDA; the card's name and power limit (nvidia-smi);
2. build: compiles ``nifty_tpu_torch/csrc/*.cu`` with nvcc (set-up time)
   and builds the 1280²- and 4096²-exact models on the card (f32) through
   the entry points, and the 1280² one on the CPU in f64 as the reference;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes: K1 (table -> full grid) and K2
   (full grid -> table) at 1024² (phase 8's geoVI grid), 1280² and 4096²,
   B = 1, 2 and 4 (the batches of the VI phases: 2 keys, 4 mirrored
   samples), and on the spherical field's own index at nside 256 (phase
   14's: a flat 1-D layout of 263,169 packed alm, bins of up to 1,025
   members); K3/K4 at 1024² (the VI grid), 1280², 4096² and 10240², and
   batches of B = 2 and 4 at 1024² and 1280² (one K3 and one K4 launch
   for the batch).  Times are device times: 20
   calls captured in one CUDA graph, replayed between CUDA events, so no
   host dispatch is in them.  Beside each: ``plain_ms`` (for K1/K2 the composition of layout
   ops the kernel replaces), ``bound_ms``, the least time the card could
   take (the larger of the bytes moved, each input read once and each
   output written once, over 3.35 TB/s and the flops over 67 TFLOP/s
   f32), and ``library_ms``, the one PyTorch call that computes the same
   function (``index_select`` / ``index_add_`` over the full-grid int32
   index, made once for them; ``rfft``; none for K4);
4. main path: ``Poissonian(data).amend(ChainModel(torch.exp, cf))`` with
   the exact-spectrum correlated field at 1280² and 4096², f32 on the
   card: the Fisher-metric apply, its median time, and at 1280² its
   agreement with the same model in f64 on the CPU;
5. cg: 20 conjugate-gradient iterations on (M + 1) x = b at 1280², the
   inner solve of an MGVI sample draw; the residual must fall below its
   value after the first iteration;
6. knot: the 64-knot model of ``bench.py:78-88`` at 1280², 4096² and
   10240², f32 on the card: the metric apply's median over 10 (CUDA
   events), peak memory, and at 1280² its agreement with the same model in
   f64 on the CPU; K3/K4 must launch and K1/K2 must not (no table);
7. vi: one MGVI and one geoVI iteration (``OptimizeVI.update``) at 1024²
   knot64 with ``bench_extra.py``'s settings (2 mirrored sample pairs,
   the draw's static CG 20 iterations, geoVI Newton-CG 2 steps of CG 5,
   the KL one Newton step of CG 10), samples mapped by the default
   ``vmap``; seconds per iteration the median of 3 after one warm-up;
   every sample and the new position finite and on the card, the
   sample-averaged KL after the Newton step not above its value before,
   K3/K4 launched.  Beside it one MGVI iteration mapped by ``lmap`` from
   the same seed (seconds and launches of one iteration side by side;
   under ``vmap`` K3 and K4 run at most half as often an iteration);
   the KL's value, gradient and metric under ``vmap`` against ``lmap`` at
   the same samples (relative 1e-5, f32 and no solve in between; the
   value relative to the sum of its terms' magnitudes); and one
   KL step by ``trust_ncg``, which must not raise the KL;
8. exact_vi: the exact-spectrum VI with ``vmap`` (``bench_extra.py``'s
   exact rows): one MGVI iteration at 1280² and one geoVI iteration at
   1024², median of 2 after one warm-up, checked as in phase 7, and one
   MGVI iteration at 1280² mapped by ``lmap``: under ``vmap`` each of
   K1-K4 runs at most half as often an iteration (one launch per batch of
   2 or 4 samples);
9. elbo: ``estimate_evidence_lower_bound`` at phase 8's 1280² MGVI
   posterior, 32 eigenvalues in 4 Lanczos batches, f32: every eigenvalue
   >= 1 - 1e-3 (the Hamiltonian metric is the likelihood's plus the
   identity), each Ritz pair's residual ||M v - λ v|| <= 1e-2 λ (a Ritz
   pair of a 42-step Lanczos with full reorthogonalisation in f32, after
   the deflation of earlier batches, is not an exact eigenpair: 1e-2 λ is
   the accuracy that still makes log λ, all the ELBO uses, good to 1 %),
   the stats finite;
10. mcmc: ``nuts_sample`` on phase 4's model at 1280² exact (counts at
   the model's own draw, f32), 4 chains on a leading axis from the latent
   that drew the counts, 8 warm-up transitions and 4 samples, depth <= 5,
   initial step 1e-3 (``MCMC``): every sample finite and on the card;
   seconds per transition, tree depths, leapfrog steps (each two batched
   gradients), ms per batched gradient (CUDA events around one call,
   median of 5), launches per transition, acceptance, divergences.  The
   batched gradient of the 4 chains' last samples, each chain against
   plain autograd in f64 on the CPU: relative L2 <= 1e-3 (the gradient
   cancels; a plain f32 one is off by up to ~2.3e-4).  Then one
   transition of each chain by ``lmap`` (``NUTSChain``, batches of one)
   and the same by ``vmap`` from the same seeds, each chain's sample
   within relative L2 1e-4 of the other map's at the same depth; one
   ``HMCChain`` transition of the 4 chains (8 leapfrog steps), all at
   chain 0's adapted step; and the energy change over 8 leapfrog steps of
   all 4 chains in one batch, from their last samples at their adapted
   steps and a numpy momentum, on the card against the same trajectories
   in f64 on the CPU: within 0.1 nats, each chain (also printed: the
   change with every sum in f32);
10b. mcmc_row: ``bench_extra.py:267-300``'s NUTS row, the 64² 16-knot
   field under a Gaussian (sigma 0.3), one ``NUTSChain``, step 0.05, depth
   <= 8: samples per second over up to 64 samples, cut at 40 s; no kernel
   runs at 64² (below K3/K4's multiple of 256, no K1/K2 in the knot form);
11. likelihoods: the Fisher metric of each likelihood of this slice (and a
   sum of two, and a complex ``Gaussian``) at 1280² exact, its mean the
   field (through ``exp``, ``sigmoid``, a pair or a stack where the
   likelihood needs it), against the same model in f64 on the CPU:
   relative L2 <= 1e-4;
12. models (``MODELS``): (a) a renormalised Matérn field at 1280² under
   ``Poissonian`` (counts at the model's own draw): the metric of the
   table form (K1-K4) and of the per-pixel form (K3/K4, not K1/K2) each
   against the table form in f64 on the CPU (1e-4), the two fields
   against each other on the card (1e-5, f32 on both sides); a ``VModel``
   of phase 4's exact field, 4 channels, every key mapped: its metric
   against 4 separate applies (1e-5), K1-K4 on a batch; (b) the density
   estimator at 1280² (a 2560² padded grid) on binned numpy events: one
   MGVI iteration with phase 8's settings under ``vmap``, checked as
   there; (c) ``NDVariableCovarianceGaussian`` at 1280², d = 2, the mean
   and the SPD matrix from a ``VModel`` of 5 fields, ``covariance`` True
   and False: energy and metric against CPU f64 (1e-4), the ms of the
   batched ``eigh`` (in chunks of ``EIGH_CHUNK`` matrices: cuSOLVER's
   batched call refuses 32,768), of the Daleckii–Krein jvp and pull-back of
   ``sym_sqrtm`` (held against CPU f64, 1e-4) and of a tabulated prior's
   interpolant (1e-6 against CPU f64: float64 tables, an f32 result);
   (d) ``MeanFieldVI`` on phase 4's 1280² model, 4 draws a step, 20 Adam
   steps: losses finite, the mean of the last 5 below that of the first
   5, K1-K4 on a batch; ``FullCovarianceVI`` on a 32² field (1,027 dof,
   no kernel), 50 steps, finite; (e) the peak memory of one metric apply
   at 4096² exact with and without ``RematModel`` (printed, no gate), the
   two within 1e-6;
13. responses (``RESPONSES``): (a) demo 1 at full width: phase 4's exact
   1280² field, ``exp``, then ``ExactGridLOS`` over 16,384 rays from the
   left edge to the right one (heights from numpy seed 41), under a
   Gaussian at the model's own draw plus 1 % noise: the tables' bytes and
   numpy seconds, the metric against the same model in f64 on the CPU over
   the same numpy tables (1e-4), two pull-backs of one cotangent through
   the LOS bit-identical (the whole model's printed leaf by leaf), the
   syncs of one metric apply
   under ``extra.no_host_transfers("log")`` (printed, no gate), the LOS's
   forward and pull-back ms, and one MGVI iteration under ``vmap`` with
   phase 8's settings, checked as there (K1-K4 on a batch); (b) the
   sampled LOS (1,024 of those rays, 2,560 points a ray) against the exact
   one on the same rays and field (2e-2 absolute and relative); (c)
   ``nufft2`` of a 1024² complex image at 2^20 points (a 2048² oversampled
   grid, width 6): 512 outputs against a direct DFT in f64 on the CPU (5e-5
   of the maximum), ⟨y, A x⟩ against ⟨Aᴴ y, x⟩ (1e-4), the gradient of a
   real loss in the coordinates through ``VariablePositionNufft`` against
   CPU f64 (1e-3), ms of ``nufft2`` and ``nufft_adjoint``; (d)
   ``HarmonicSKI`` on a 1024² grid of inducing points padded to 1536² (K3
   and K4 launch, not K1/K2) at 2^18 points against CPU f64 (1e-4), its
   symmetry ⟨y, C x⟩ = ⟨C y, x⟩ (1e-5 of ‖y‖‖C x‖), ``ToeplitzSKI`` on a
   1-D grid of 2^20 points (1e-4); (e) ``dynamic_lightcone_operator`` on a
   (512, 1024) grid padded by (64, 64): value, jvp and vjp against CPU f64
   at the card's float32-rounded inputs (1e-4; the lightspeed latent's
   vjp, one sum over the grid, at the scale of its terms' magnitudes),
   and at 1280² ``regrid`` to 2048²,
   ``func_convolution`` and ``linear_interpolation`` at 2^20 points, each
   against CPU f64 (1e-5 of the maximum), with their ms;
14. sphere (``SPHERE``): (a) K5 (the Legendre contraction of the
   spherical-harmonic synthesis) and K6 (its adjoint) against their plain
   versions in float64 on the card at nside 64, 256 and 512 (lmax 2 nside),
   B = 1, 2 and 4, at all three also B = 8 and 16 (the smallest batches on
   the tensor cores; at nside 512 K6 sums its two ring chunks in a second
   launch, counted as such), and at the plans and batches (d) and (e)
   give them (nside 64: lmax 96, B = 1; lmax 128, B = 256) and B = 6 (1e-5
   of the maximum, and by m band at B = 1; K6 the same bits twice), device
   ms, bound (f32 operations and 4 f64 operations a recurrence step), plain
   ms, and up to nside 256 the library yardstick: one ``torch.bmm`` against
   a float32 λ table precomputed outside the timing (contraction only);
   (b) ``HealpixSynthesis`` at those nsides: its tables' host seconds,
   device and wall ms, at 64 and 256 against float64 on the CPU (1e-5);
   (c) ``bench_extra.py:98-125``'s spherical field at nside 256 (786,432
   pixels) under a Gaussian (noise std 0.2) at its own draw: the metric
   against CPU f64 (1e-4; K1, K2, K5, K6 launched) and one MGVI iteration
   under ``vmap`` checked as in phase 8; (d) ``healpix_analysis`` of a
   band-limited map at nside 64 (lmax 96): the alm back within 1e-3;
   (e) a sphere at nside 64 times a regular 256 axis: the metric against
   CPU f64 (1e-4);
15. icr (``ICR``; no kernel of the port may launch): ``bench_extra.py:305``'s
   ``ICRField`` (a 16² open grid, depth 6: 772² fine pixels) and demo 4's
   learned Matérn field on the same grid (its table from r = 1e-3, below
   the grid's finest spacing), a ``HEALPixICRField`` (nside0 8,
   depth 4) and a ``SphereRadiusICRField`` (nside0 2, 16 shells, depth 3),
   each built in float64 on the CPU (seconds printed; a build over 60 s
   lowers the depth a step) and copied in float32 to the card: forward and
   metric ms, both against CPU f64 (1e-4), and one MGVI iteration of the
   first under ``vmap``, checked as in phase 8;
16. aux (``AUX``): the diagnostics and the output on phase 4's exact model
   at 1280² (f32 on the card, f64 on the CPU as the reference): (a)
   ``probe_diagonal`` of the metric from 8 Rademacher probes drawn on the
   CPU from the seed, against the same probes through the CPU metric
   (1e-4 relative L2); (b) ``operator_spectrum`` of the metric, its 8
   leading eigenvalues from one Lanczos batch (42 applies) against the
   same Lanczos on the CPU from the same start vector (1e-4 relative,
   seconds printed); (c) ``compute_empirical_power_spectrum`` of the field
   at 128 shells against numpy ``fftn`` and ``bincount`` in float64 at the
   card's field (1e-5 of the maximum), the same bits on two calls, and the
   gradient of the power in the 8 lowest shells against CPU f64 (1e-4);
   (d) ``check_model`` of the field: each mode's eager and device time and
   peak memory, all finite and positive; (e) ``adjust_variances`` on the
   field's ξ (φ = A ξ kept to 1e-5) and one MGVI iteration of
   ``optimize_kl`` under ``vmap`` with ``odir`` in a temporary directory, an
   exported operator and a ``kl_reduce`` of its own: ``last.pkl`` back
   through ``load_samples`` with the same bits, the operator's mean and
   standard deviation finite and of the field's shape;
17. parallel (``PARALLEL``, the multi-GPU slice): (a) at 4096² over 8, 4
   and 2 virtual ranks (each rank's block launched in turn in this
   process): the pencil Hartley's per-rank stages (K3 on a rank's rows, the
   exchanges as transposes of the ranks' packed buffers, K4r reading each
   rank's receive buffer in place and writing its send buffer) against
   ``hartley2d`` (1e-6 of max|H|), K4r on every rank's receive buffer
   against its plain version (also at 10240² over 4 ranks and at 4096²
   with B = 2, the draws' batch), K1r against K1's rows (bit-exact) and the
   K2r parts, each the same bits twice, summed against K2 in float64
   (1e-6), at B = 1 and 2; times of rank 0's block as in phase 3 (K1r and
   K2r also rank p/2's, whose rows mirror rank 0's, at B = 1 and 2, beside
   the least bytes the range needs), stage 2's device time from the receive
   buffer to the send buffer beside the same kernel with the former join
   and cut copies around it, the library
   yardsticks ``rfft`` of the rows, ``fft(dim=0)`` of the column block,
   ``index_select`` / ``index_add_`` over the rows' full-grid index; (b) a
   one-rank NCCL group: ``sharded_hartley2`` at 4096² through a real
   ``all_to_all_single``, the row-sharded exact and 64-knot metric at 4096²
   against the unsharded (relative 1e-6), and one MGVI iteration at 1280²
   exact through ``optimize_kl`` with ``position_sharding=`` and with
   ``devices=`` against the unsharded iteration from the same seed at
   phase 8's settings (KL not rising, the distance printed) and with CG and
   Newton-CG cut to 3 steps (relative 1e-4); (c) phase 13a's tomography,
   its model and tables reused: the LOS cut to the rows of 8, 4 and 2
   virtual ranks, the ranks' partial ray sums added and their pull-backs
   of one cotangent joined against the whole LOS (1e-6 of max), then on
   the one-rank group the row-sharded tomography metric (inside the field
   context, the rank's share of the rays' data) against 13a's unsharded
   one (relative L2 1e-5) and one MGVI iteration by
   ``position_sharding=`` against the unsharded at CG 3 (1e-4); (d)
   ``optimize_kl`` of (c) with ``odir`` and an exported field: two
   iterations against one and a resume to the second (1e-4), ``last.pkl``
   the gathered samples bit for bit; (e) phase 10's ``nuts_sample`` with
   ``chain_map="pmap"`` against phase 10's ``"vmap"`` chains (the same
   tree depths, relative L2 1e-2: a whole run amplifies f32 rounding);
   (f, ``LARGE``) the sharded NUFFT's per-rank stages at 4096² and 2^20
   points over 2, 4 and 8 virtual ranks against ``nufft2`` and
   ``nufft_adjoint`` (1e-5 of the maximum, the joined pull-backs the same
   bits twice; rank 0's stage times), then on the group a Gaussian over
   ``nufft2(exp(cf(x)), coords)`` with the exact 4096² field: its metric and
   energy against the unsharded (1e-5) and one MGVI iteration at CG 3
   (1e-4, the step moving); (g) SKI's interpolation (grid 1024, 2^18
   points) cut to the rows of 2, 4 and 8 virtual ranks against the whole
   matrix (1e-6), a SKI likelihood of the sharded 1024² field on the group
   (1e-5), and K7 against its plain version at 10^8 entries (the words the
   same bits, the f32 normals 1e-6 of the maximum, f64 1e-12), a rank's
   rows of a draw against the whole draw's, bit for bit, and K7's time
   beside ``torch.randn``'s, its byte bound and its issue bound (the SASS
   instructions of its main loop a group, ``cuobjdump``, over 4
   schedulers on each SM at the maximum SM clock).

The launch counters are set to 0 just before each of phases 4-6, 9, 10b
and 11, and before each VI run of phases 7 and 8 (``vi_mgvi_vmap``,
``vi_geovi_vmap``, ``vi_mgvi_lmap``, ``vi_kl``, ``exact_mgvi_vmap``,
``exact_mgvi_lmap``, ``exact_geovi_vmap``), each run of phase 10
(``mcmc_nuts``, ``mcmc_nuts_lmap``, ``mcmc_nuts_vmap``, ``mcmc_hmc``) and
each sub-phase of 12 (``matern_table``, ``matern_pixel``, ``vmodel``,
``density_mgvi_vmap``, ``ndvcg_covariance``, ``ndvcg_precision``,
``vi_meanfield``, ``vi_fullcov``, ``remat``) and of 13
(``responses_tomography``, ``responses_tomography_mgvi_vmap``,
``responses_sampled``, ``responses_nufft``, ``responses_ski``,
``responses_dynamics_operators``), of 14 (``sphere_metric``,
``sphere_mgvi_vmap``, ``sphere_analysis``, ``sphere_product``) and of 15
(``icr_fixed``, ``icr_mgvi_vmap``, ``icr_matern``, ``icr_healpix``,
``icr_sphere_radius``) and of 16 (``aux_probing``, ``aux_spectrum``,
``aux_power``, ``aux_check_model``, ``aux_adjust_optimize_kl``) and of
17b (``parallel_hartley``, ``parallel_metric_exact``,
``parallel_metric_knot64``, ``parallel_vi_position_sharding``,
``parallel_vi_devices``), 17c (``parallel_tomography_metric``,
``parallel_tomography_vi``), 17d (``parallel_odir``), 17e
(``parallel_nuts_pmap``), 17f (``parallel_nufft_metric``,
``parallel_nufft_vi``), 17g (``parallel_ski_metric``) and 17h
(``parallel_learned_metric``, ``parallel_learned_vi``,
``parallel_dynamics``), and read just after it:
K1-K4 must launch in phases 4, 5, 8-11, 12 (but for the Matérn pixel
form and the 32² full-covariance VI) and 13a, K3/K4 (and not K1/K2) in 6,
7, the pixel form and 13d, none in 10b, the 32² VI and 13b, c and e, and
each VI run's kernels in
its last iteration too; K1, K2, K5 and K6 (not K3/K4) in 14c, K5/K6 in 14d,
K1, K2, K5 and K6 in 14e, none in 15, K1-K4 (not K5/K6) in each of 16a-e;
K3 and K4r (not K4) in 17b's Hartley and knot metric, K1r, K2r, K3 and K4r
(not K1, K2, K4) in its exact metric and its position-sharded MGVI, K1-K4
(not the range forms) in its MGVI by ``devices=``; K1r, K2r, K3 and K4r (not
K1, K2, K4) in each run of 17c and 17d, K1-K4 on a batch in 17e, K1r,
K2r, K3 and K4r (not K1, K2, K4) in 17f-h's runs, none in 17h's light
cone; K7 in 17b's MGVI iterations, 17f's and 17h's (every sampler draws
its noise by K7, so no phase that samples refuses it);
under ``vmap`` (and in the ``VModel``, density, NDVCG and mean-field runs) each must have launched on a batch of samples,
chains or channels (``native.batched_launches``), under ``lmap`` none.
Then it prints the whole run's seconds, the card line, the kernel summary
(launches per phase) and, last, ``{"ok": true, "device": ...}``.  Any
failure raises, so the exit code is not 0 and no result line is printed.

Tolerances (and why): K1 exact (a gather computes nothing); K2 relative
1e-6 against its float64 plain version (f32 sums over one bin in a fixed
order), and the same bits on two calls; Hartley max|Δ|/max|ref| <= 1e-5 (f32 FFT rounding); metric
relative L2 <= 1e-4 against float64 on the CPU (f32 through exp and
three Hartleys); the leapfrog energy change within 0.1 nats of float64 (a
NUTS transition turns such differences into probabilities).  TF32 is off
for matmuls and cuDNN, so no library call rounds to 10-bit mantissas
behind the comparison.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

DEVICE = "cuda:0"
SHAPES_MAIN = (1280, 4096)
SHAPES_KNOT = (1280, 4096, 10240)
KNOTS = 64
VI_SHAPE = 1024
SHAPES_HARTLEY = (VI_SHAPE, 1280, 4096, 10240)  # ascending: the summary keeps 4096²'s times
SHAPES_HARTLEY_BATCH = (VI_SHAPE, 1280)  # the VI grids: B = 4 samples in one K3 + K4 pair
EXACT_VI = {"linear_resample": 1280, "nonlinear_resample": 1024}  # bench_extra.py's exact rows
ELBO = dict(n_eigenvalues=32, n_batches=4)
MCMC = dict(shape=1280, chains=4, n_warmup=8, n_samples=4, max_tree_depth=5, step_size=1e-3,
            hmc_steps=8, seed=21)
NUTS_ROW = dict(shape=64, n_samples=64, budget_s=40.0)  # bench_extra.py:267's 64 samples, cut by time
MODELS = dict(matern=1280, channels=4, density=(1280, 1280), density_events=4_000_000, ndvcg=1280,
              vi=1280, vi_samples=4, vi_steps=20, fullcov=32, fullcov_steps=50, remat=4096, seed=23)
RESPONSES = dict(shape=1280, rays=16384, sampled_rays=1024, sampled_points=2560, nufft_shape=1024,
                 nufft_points=2**20, nufft_checked=512, ski_grid=1024, ski_padding=0.5,
                 ski_points=2**18, toeplitz_grid=2**20, toeplitz_points=2**18,
                 dynamics=(512, 1024), dynamics_padding=(64, 64), operators=1280, regrid=2048,
                 interp_points=2**20, seed=41)
# phase 14: K5/K6 and the synthesis at bench_extra.py:66,326,330's nsides (lmax 2 nside),
# the spherical field of bench_extra.py:98-125 at nside 256 (noise std 0.2), the analysis'
# round trip at nside 64 (lmax 1.5 nside), a sphere (nside 64) times a regular 256 axis
# K5/K6 also at B = 8 and 16 at `tensor_core_nsides`; their library yardstick (a batched
# matrix product against a float32 λ table, 1.1 GB at nside 256) up to `table_max_nside`:
# at nside 512 the table and its float64 rows would hold ~26 GB of the card
SPHERE = dict(kernel_nsides=(64, 256, 512), checked=(64, 256), field=256, noise=0.2,
              analysis=64, product=(64, 256), tensor_core_nsides=(64, 256, 512), table_max_nside=256)
# phase 15: bench_extra.py:305's ICR field (16², depth 6: 772² fine pixels) and demo 4's
# learned Matérn one on that grid, a HEALPix field (nside0 8, depth 4: nside 128) and a
# sphere x log-radius field (nside0 2, 16 shells, depth 3); a depth that takes more than
# `build_limit_s` of host time to build is lowered one step at a time
ICR = dict(depth=6, healpix=(8, 4), sphere_radius=(2, 16, 3), noise=0.1, build_limit_s=60.0)
# phase 16: the diagnostics and the output on phase 4's exact model at 1280²: 8 probes,
# 8 eigenvalues (one Lanczos batch: 42 metric applies), a spectrum of 128 shells
AUX = dict(shape=1280, probes=8, eigenvalues=8, bins=128, low_shells=8, seed=71)
# phase 17: the multi-GPU slice at 1280² (a rank's rows no multiple of 256) and 4096²
# over 8, 4 and 2 virtual ranks (the kernel summary keeps the last: 4096², the largest
# block a rank), then a one-rank NCCL group:
# the pencil Hartley and the metric at 4096², an MGVI iteration at phase 8's 1280²
PARALLEL = dict(shapes=(1280, 4096), ranks=(8, 4, 2), metric_knots=(None, 64), vi=1280, seed=81,
                k4r_more=((10240, 1, (4,)), (4096, 2, (8, 4, 2))))  # 17a: (n, B, ranks)
# phase 17f-g: phase 13c's NUFFT image grown to 4096² (a complex64 oversampled frame of
# 8192², 512 MB) at 2^20 points, its stages over 2, 4 and 8 virtual ranks, and radio
# imaging through it on the one-rank group; phase 13's SKI (grid 1024, 2^18 points) on a
# sharded 1024² field; K7 at 10^8 entries, its row ranges on a 4096² leaf
LARGE = dict(nufft_shape=4096, nufft_points=2**20, ranks=(2, 4, 8), ski_grid=1024,
             ski_points=2**18, k7_entries=10**8, k7_f64_entries=10**7, k7_rows=4096, seed=91)
# phase 17h: radio imaging with learned coordinates (17f's exact 4096² field through exp and
# VariablePositionNufft at 2^20 points, the coordinates base + 1e-4 uv with uv a latent;
# its MGVI iteration over 4 mirrored sample pairs, 8 sets of coordinates a KL evaluation),
# 17f's stages at 2^20 + 3 points (shares that differ by one over 2, 4 and 8 virtual ranks),
# and phase 13e's light cone, (512, 1024) padded by (64, 64), on a row-split latent
LEARNED = dict(nufft_shape=4096, nufft_points=2**20, uneven_points=2**20 + 3, ranks=(2, 4, 8),
               taps_cuts=3, vi_samples=4, dynamics=(512, 1024), dynamics_padding=(64, 64), seed=97)
CG_ITERS = 20
NAMES = {"K1": "expand_to_grid", "K2": "collapse_from_grid",
         "K3": "hartley_rows", "K4": "hartley_cols",
         "K5": "legendre_contract", "K6": "legendre_contract_t",
         "K1r": "expand_to_grid_rows", "K2r": "collapse_from_grid_rows",
         "K4r": "hartley_cols_range", "K7": "philox_normal"}
TRANSFORMS = tuple(k for k in NAMES if k != "K7")  # every kernel but the noise draw of the samplers
SHARDED = ("K1r", "K2r", "K3", "K4r")  # the row-sharded exact field's kernels
FIELD = ("K1", "K2", "K3", "K4")  # the regular-grid field's kernels
SPHERE_KERNELS = ("K1", "K2", "K5", "K6")  # the spherical field's
TOL = {"k2": 1e-6, "hartley": 1e-5, "metric": 1e-4, "kl_maps": 1e-5,  # K1 must be exact
       "eigenvalue": 1e-3, "ritz": 1e-2, "dH": 0.1,
       # the posterior's gradient cancels: its global leaves sum ~1.6e6 terms of
       # both signs, so a plain float32 gradient is itself off by up to ~2.3e-4
       "gradient": 1e-3,
       # phase 12: table against pixel Matérn and a VModel against separate
       # applies, f32 on both sides; RematModel reruns the same kernels;
       # the interpolant evaluates float64 tables and rounds once to f32
       "forms": 1e-5, "remat": 1e-6, "interp": 1e-6,
       # phase 13: the sampled against the exact LOS (two discretisations of one
       # integral, tests/test_responses.py's 2e-2); the NUFFT at width 6 against a
       # direct DFT (5e-5 of the maximum, its own accuracy); inner products of f32
       # results summed in f64; SKI through f32 Hartleys; the operators' f32
       # rounding (the interpolation's coordinates stay float64)
       "sampled_los": 2e-2, "nufft_dft": 5e-5, "adjoint": 1e-4, "nufft_grad": 1e-3,
       "ski": 1e-4, "symmetry": 1e-5, "operators": 1e-5,
       # phase 14: K5/K6 (float32 sums over up to lmax + 1 terms, the recurrence in
       # float64 in both) and the synthesis (and FFT rounding) against float64, of the
       # maximum; the analysis' CG, in float32, to the JAX package's own 1e-3 (relative L2)
       "legendre": 1e-5, "synthesis": 1e-5, "analysis": 1e-3,
       # phase 16: the power spectrum (f32 FFT and sums) against numpy in float64, of
       # the maximum; φ = A ξ recomputed as A_new (φ / A_new) in float32
       "power": 1e-5,
       # phase 17: the pencil Hartley (K3 + K4r over the ranks) against K3 + K4, of
       # max|H|; the one-rank sharded metric against the unsharded (the same kernels'
       # arithmetic, sums in another order); one MGVI iteration sharded against
       # unsharded from the same seed with its CG and Newton-CG cut to 3 steps: at
       # phase 8's 20 CG steps past convergence, rounding grows without bound (on
       # the CPU in float64 the two runs part by 4e-17 at 3 steps, 4e-6 at 20)
       "pencil": 1e-6, "sharded_metric": 1e-6, "sharded_vi": 1e-4,
       # 17c: the LOS's row blocks (f32 sums of a ray's segments, regrouped by rank)
       # against the whole, of the maximum; the sharded tomography metric against
       # 13a's (the partial ray sums add over the ranks in another order)
       "los_rows": 1e-6, "tomography_metric": 1e-5,
       # 17e: whole NUTS runs (12 transitions of up to 31 leapfrog steps) amplify
       # float32 rounding: a batch of one against the 4-chain batch on the CPU parts
       # by 1.7e-3 after phase 10's run, another chain by O(1); the depths must agree
       "chains": 1e-2,
       # 17f: the sharded NUFFT's stages against the unsharded nufft2 / nufft_adjoint,
       # both f32 (FFTs of another factorisation, taps weighted in float64 then rounded),
       # of the maximum; its metric and energy against the unsharded (relative L2)
       "nufft_stages": 1e-5, "nufft_metric": 1e-5,
       # 17f: its MGVI iteration at CG 3 against the unsharded, of the unsharded step
       # ||ref - start|| (the step is ~2.5e-4 of the position, so 1e-4 of the position
       # would pass a step 40 % off): 5.3e-5 measured on one H100 (1.32e-8 of the
       # position over a step of 2.49e-4), 1.9e-5 on four (4.6e-9 over 2.47e-4)
       "nufft_vi_step": 1e-3,
       # 17g: SKI's row blocks against the whole matrix (f32 sums of 4 corners regrouped
       # by rank), of the maximum; K7's f32 normals (logf, sincospif in f32) against the
       # plain version's float64 Box-Muller rounded once, of the maximum; its f64 ones
       "ski_rows": 1e-6, "k7": 1e-6, "k7_f64": 1e-12,
       # 17h: the learned coordinates' one-rank metric against the unsharded (relative
       # L2; f32 taps and their derivatives, weighted in float64 then rounded, against
       # the unsharded's f32 autograd of the window) and its MGVI iteration at CG 3, of
       # the unsharded step, as 17f's; the light cone's rows on a row-split latent
       # against the unsharded (the same FFTs of the gathered latent), of the maximum
       "learned_metric": 1e-4, "learned_vi_step": 1e-3, "cone_rows": 1e-6}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def aux_phase(dev, read_launches, rel_l2):
    """Phase 16 (``AUX``): probing, the operator spectrum, the empirical
    power spectrum, ``check_model``, ``adjust_variances`` and one
    ``optimize_kl`` iteration with its outputs, on phase 4's exact model
    (float32 on ``dev``, float64 on the CPU as the reference).  Each
    sub-phase's launches are read by ``read_launches`` (K1-K4 must launch,
    K5/K6 must not)."""
    import numpy as np
    import torch

    import nifty_tpu_torch as nt
    from nifty_tpu_torch import native
    from nifty_tpu_torch.bench.workload import bench_field, build_likelihood, vi_settings
    from nifty_tpu_torch.utils.tree import tree_map

    t16 = time.perf_counter()
    n, seed, off = AUX["shape"], AUX["seed"], ("K5", "K6")
    f32, f64 = torch.float32, torch.float64
    lh, pos_np, _ = build_likelihood(n, dev, f32)
    lh64, _, _ = build_likelihood(n, "cpu", f64)
    cf, cf64 = bench_field(n, dev, f32), bench_field(n, "cpu", f64)
    p, p64 = (nt.position_from_numpy(m, pos_np) for m in (cf, cf64))

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def metric(likelihood, q):
        return lambda t: likelihood.metric(q, t)

    # 16a. the metric's diagonal from 8 Rademacher probes drawn on the CPU from the seed
    native.reset_launches()
    diag, secs = timed(lambda: nt.probe_diagonal(metric(lh, p), p, seed, n_probes=AUX["probes"]))
    read_launches("aux_probing", FIELD, refuse=off)
    err = rel_l2(diag, nt.probe_diagonal(metric(lh64, p64), p64, seed, n_probes=AUX["probes"]))
    emit({"phase": "aux_probing", "shape": [n, n], "probes": AUX["probes"], "seconds": secs,
          "rel_l2_vs_cpu_f64": err})
    if not err <= TOL["metric"]:
        fail(f"aux_probing: the diagonal {err} off CPU f64 > {TOL['metric']}")

    # 16b. the metric's leading eigenvalues, one Lanczos batch from the seed's start vector
    native.reset_launches()
    kw = dict(key=seed, n_batches=1)
    vals, secs = timed(lambda: nt.operator_spectrum(metric(lh, p), p, AUX["eigenvalues"], **kw))
    read_launches("aux_spectrum", FIELD, refuse=off)
    ref = nt.operator_spectrum(metric(lh64, p64), p64, AUX["eigenvalues"], **kw)
    err = float(np.max(np.abs(vals - ref) / np.abs(ref))) if vals.shape == ref.shape else float("inf")
    emit({"phase": "aux_spectrum", "shape": [n, n], "eigenvalues": vals.tolist(),
          "eigenvalues_cpu_f64": ref.tolist(), "rel_err_vs_cpu_f64": err, "seconds": secs})
    if not err <= TOL["metric"]:
        fail(f"aux_spectrum: eigenvalues {err} off CPU f64 > {TOL['metric']}")

    # 16c. the field's empirical power spectrum (twice: the same bits), and the
    # gradient of its power in the lowest shells (the field's pull-back)
    def spectrum(x):
        return nt.compute_empirical_power_spectrum(x, distances=1.0 / n, n_bins=AUX["bins"])[0]

    def low_power(model):
        return torch.func.grad(lambda q: spectrum(model(q))[: AUX["low_shells"]].sum())

    native.reset_launches()
    with torch.no_grad():
        field = cf(p)
    ps, secs = timed(lambda: spectrum(field))
    same = torch.equal(ps, spectrum(field))
    grad, grad_s = timed(lambda: low_power(cf)(p))
    read_launches("aux_power", FIELD, refuse=off)
    x = field.double().cpu().numpy()  # numpy fftn and bincount in float64 at the card's field
    kk = np.fft.fftfreq(n, d=1.0 / n)
    k_mag = np.sqrt(kk[:, None] ** 2 + kk[None, :] ** 2).ravel()
    edges = np.geomspace(1.0, float(n), AUX["bins"] + 1)
    idx = np.clip(np.digitize(k_mag, edges) - 1, 0, AUX["bins"] - 1)
    counts = np.bincount(idx, minlength=AUX["bins"])
    sums = np.bincount(idx, weights=(np.abs(np.fft.fftn(x)) ** 2).ravel(), minlength=AUX["bins"])
    ref = torch.from_numpy((sums / np.maximum(counts, 1))[counts > 0])
    err = rel_max(ps.double().cpu(), ref) if ps.shape == ref.shape else float("inf")
    grad_err = rel_l2(grad, low_power(cf64)(p64))
    emit({"phase": "aux_power", "shape": [n, n], "shells": int(ps.numel()), "seconds": secs,
          "rel_max_vs_numpy_f64": err, "same_bits_twice": same, "low_power_grad_seconds": grad_s,
          "low_power_grad_rel_l2_vs_cpu_f64": grad_err})
    if not (err <= TOL["power"] and same and grad_err <= TOL["metric"]):
        fail(f"aux_power: {err} off numpy (> {TOL['power']}?), the same bits twice {same}, "
             f"the gradient {grad_err} off CPU f64 (> {TOL['metric']}?)")

    # 16d. check_model of the field: eager, device time and peak memory of each mode
    native.reset_launches()
    report, secs = timed(lambda: nt.check_model(cf, p, log=lambda msg: None))
    read_launches("aux_check_model", FIELD, refuse=off)
    emit({"phase": "aux_check_model", "shape": [n, n], "seconds": secs, "report": report})
    for mode, r in report.items():
        nums = [r["time_raw"]] + ([r["device_ms"], r["peak_bytes"]] if dev.type == "cuda" else [])
        if not all(np.isfinite(v) and v > 0 for v in nums):
            fail(f"aux_check_model: {mode} {r}")

    # 16e. adjust_variances on the field's ξ; one MGVI iteration of optimize_kl under
    # vmap with odir, an exported operator and a kl_reduce of its own (the mean in f64)
    native.reset_launches()
    amp = cf.harmonic_amplitude
    new, adjust_s = timed(lambda: nt.adjust_variances(
        p, amp, cf.xi_key, minimize_kwargs=dict(maxiter=5, cg_kwargs=dict(maxiter=10))))
    with torch.no_grad():
        phi_err = rel_max(amp(new) * new[cf.xi_key], amp(p) * p[cf.xi_key])
    moved = {k: float((new[k] - p[k]).abs().max()) for k in p if k != cf.xi_key}
    reduce64 = lambda t: tree_map(lambda v: v.double().mean(dim=0).to(v.dtype), t)  # noqa: E731
    with tempfile.TemporaryDirectory() as odir:
        (samples, state), vi_s = timed(lambda: nt.optimize_kl(
            lh, nt.position_from_numpy(lh.forward_model, pos_np),
            key=torch.Generator(device=dev).manual_seed(seed), n_total_iterations=1,
            kl_reduce=reduce64, odir=odir, export_operators={"sky": lh.forward_model},
            sample_mode="linear_resample", **vi_settings()))
        read_launches("aux_adjust_optimize_kl", FIELD, refuse=off, batch=FIELD)
        back = nt.io.load_samples(os.path.join(odir, "last.pkl"), device=dev)
        same = all(torch.equal(back.pos[k], samples.pos[k])
                   and torch.equal(back._samples[k], samples._samples[k]) for k in samples.pos)
        out = np.load(os.path.join(odir, "operator_outputs", "sky_last.npz"))
        npz_ok = all(out[k].shape == (n, n) and np.isfinite(out[k]).all() for k in ("mean", "std"))
        files = sorted(os.listdir(odir))
    emit({"phase": "aux_adjust_optimize_kl", "shape": [n, n], "adjust_seconds": adjust_s,
          "phi_rel_max": phi_err, "hyperparameters_moved": moved, "vi_seconds": vi_s,
          "samples": len(samples), "kl": float(state.minimization_state.fun),
          "checkpoint_same_bits": same, "operator_npz_ok": npz_ok, "odir": files})
    if not (phi_err <= TOL["power"] and same and npz_ok):
        fail(f"aux_adjust_optimize_kl: φ {phi_err} (> {TOL['power']}?), last.pkl back with the "
             f"same bits {same}, the operator's mean and std finite of shape {(n, n)} {npz_ok}")
    emit({"phase": "aux_total", "seconds": time.perf_counter() - t16})


def parallel_phase(dev, read_launches, timing, built=None, tomo=None, nuts=None):
    """Phase 17 (``PARALLEL``): (a) the range kernels at ``shape``² over
    virtual ranks, each rank's block launched in turn in this process: the
    pencil Hartley's stages (K3 on a rank's rows, K4r on its column block)
    composed against ``hartley2d``, K4r against its plain version on every
    rank's block, K1r against K1's rows (bit-exact) and the K2r parts summed
    against K2 in float64; the times of rank 0's block (``timing``); (b) a
    one-rank group (NCCL on the card, gloo on the CPU): ``sharded_hartley2``
    through a real ``all_to_all_single``, the exact and knot metric of the
    row-sharded field against the unsharded one, and one MGVI iteration by
    ``optimize_kl`` with ``position_sharding=`` and with ``devices=``
    against the unsharded iteration from the same seed.  Launches are read
    by ``read_launches`` after each run of (b); ``built`` maps a shape to
    phase 4's unsharded exact ``build_likelihood`` of it, reused.  Then,
    with ``tomo`` (phase 13a's likelihood, start and tangent) and ``nuts``
    (phase 10's model, start and ``"vmap"`` chains): (c) the sharded
    tomography, (d) ``optimize_kl`` with ``odir`` and a resume across the
    group, (e) ``nuts_sample(chain_map="pmap")``.  Returns the kernel
    summary rows of K1r, K2r and K4r."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import nifty_tpu_torch as nt
    from nifty_tpu_torch import native, parallel
    from nifty_tpu_torch.bench.timing import bound, device_ms, fft_flops
    from nifty_tpu_torch import io
    from nifty_tpu_torch.bench.workload import (build_likelihood, build_vi_likelihood, grid_index,
                                                sharded_tomography, short_vi_settings, vi_settings)
    from nifty_tpu_torch.ops import cuda_expand as ce
    from nifty_tpu_torch.ops import cuda_fft as cfft
    from nifty_tpu_torch.parallel.fft import pencil_stages, uses_kernels

    def k4r_times(n, p, recv, cols_):
        """K4r on rank 0's receive buffer ``recv`` (``(p, B, n/p, w + 8)``):
        its times, bound and yardsticks (``timing``: the plain version,
        ``fft(dim=0)`` of the joined block), and stage 2's device time from
        the receive buffer to the send buffer, beside the same kernel with
        stage 2's former copies (the chunks joined, the output cut and
        packed for ``all_to_all``)."""
        B, b, w = recv.shape[1], recv.shape[2], n // (2 * p)
        blk = torch.cat(list(recv), dim=1)
        k4r = timing(device_ms(lambda: cfft.hartley_cols_range(recv, w, n1=n)),
                     device_ms(lambda: cfft.hartley_cols_range_plain(recv, w)),
                     B * (8 * n * (w + 1) + 4 * n * 2 * w), B * fft_flops(n, w + 1),
                     library_ms=device_ms(lambda: torch.fft.fft(blk[..., :w + 1], dim=-2)))
        copies_ms = device_ms(lambda: torch.cat([c.contiguous().reshape(-1) for c in cfft.hartley_cols_range(
            blk, w, n1=n).split(b, dim=1)]))
        return k4r, {"batch": B, "launch": list(cfft.range_launch(n, w, B)),
                     "stage2_ms": device_ms(lambda: cols_(recv, 0)), "stage2_with_copies_ms": copies_ms}

    def ranges_17a_more(g):
        """17a at 10240² over 4 virtual ranks and at 4096² with B = 2 (the
        draws' batch) over 2, 4 and 8: K4r on every rank's receive buffer
        against its plain version, rank 0's times."""
        for n, B, ranks in PARALLEL["k4r_more"]:
            x = torch.randn((B, n, n), generator=g, device=dev)
            G = cfft.hartley_rows(x)
            if G.stride(-2) != cfft.half_spectrum_pitch(n):  # the plain version's (the CPU)
                G = cfft.padded_half_spectrum(G)
            del x
            Gp = torch.as_strided(G, (B, n, cfft.half_spectrum_pitch(n)), G.stride(), G.storage_offset())
            for p in ranks:
                b, w = n // p, n // (2 * p)
                _, cols_, _ = pencil_stages((n, n), p, f32)
                e4, scale = 0.0, 0.0
                for r in range(p):
                    recv = torch.stack([Gp[:, s * b:(s + 1) * b, r * w:r * w + w + 8] for s in range(p)])
                    ref = cfft.hartley_cols_range_plain(recv, w)
                    e4 = max(e4, float((cfft.hartley_cols_range(recv, w, n1=n) - ref).abs().max()))
                    scale = max(scale, float(ref.abs().max()))
                    if r:
                        del recv
                if not e4 / scale <= TOL["hartley"]:
                    fail(f"parallel: K4r {e4 / scale} > {TOL['hartley']} off its plain version at "
                         f"{n}², B = {B}, p = {p}")
                recv = torch.stack([Gp[:, s * b:(s + 1) * b, :w + 8] for s in range(p)])
                k4r, stage2 = k4r_times(n, p, recv, cols_)
                emit({"phase": "kernels", "kernel": "K4r", "shape": [n, n], "ranks": p, "rows": b,
                      "columns": w, "k4r_rel_err": e4 / scale, **stage2,
                      **{f"k4r_{k}": v for k, v in k4r.items()}})
                del recv
            del G, Gp

    def ranges_17a(n, g, summary, timing):
        """17a at ``n``²: the pencil Hartley and K4r, K1r and K2r over the
        virtual ranks; returns the input, its Hartley and max|H|."""
        full = (n, n)
        # 17a. the pencil Hartley and K4r
        x = torch.randn(full, generator=g, device=dev)
        H = cfft.hartley2d(x)
        scale = float(H.abs().max())
        for p in PARALLEL["ranks"]:
            if not uses_kernels(full, p, f32):
                fail(f"parallel: {n}² over {p} ranks is outside K3 + K4r's domain")
            rows_, cols_, place_ = pencil_stages(full, p, f32)
            b, w = n // p, n // (2 * p)
            sent = [rows_(x[None, r * b:(r + 1) * b]) for r in range(p)]  # (p, 1, b, w + 8) each
            # rank s's receive buffer, sender-major, as the exchange leaves it
            recv = [torch.stack([sent[r][s] for r in range(p)]) for s in range(p)]
            del sent
            packed = [cols_(recv[s], s) for s in range(p)]  # K4r in place: the send buffers
            got = torch.cat([place_(torch.stack([packed[s][r] for s in range(p)]), r)
                             for r in range(p)], dim=1)[0]
            e_pencil = float((got - H).abs().max()) / scale
            e4 = max(float((packed[s] - cfft.hartley_cols_range_plain(recv[s], w)).abs().max())
                     for s in range(p))
            del packed, got
            if not e_pencil <= TOL["pencil"]:
                fail(f"parallel: the pencil Hartley over {p} ranks is {e_pencil} > {TOL['pencil']} off")
            if not e4 / scale <= TOL["hartley"]:
                fail(f"parallel: K4r {e4 / scale} > {TOL['hartley']} off its plain version at p={p}")
            xr = x[:b]
            rfft_ms = device_ms(lambda: cfft.hartley_rows_plain(xr))
            k3 = timing(device_ms(lambda: cfft.hartley_rows(xr)), rfft_ms,
                        4 * b * n + 8 * b * (n // 2 + 1), fft_flops(n, b // 2), library_ms=rfft_ms)
            k4r, stage2 = k4r_times(n, p, recv[0], cols_)
            emit({"phase": "kernels", "kernel": "K3+K4r", "shape": [n, n], "ranks": p,
                  "rows": b, "columns": w, "pencil_rel_err": e_pencil, "k4r_abs_err": e4, **stage2,
                  **{f"k3_{k}": v for k, v in k3.items()}, **{f"k4r_{k}": v for k, v in k4r.items()}})
            summary["K4r"] = dict(max_abs_err=max(e4, summary.get("K4r", {}).get("max_abs_err", 0.0)),
                                  ranks=p, **k4r)
            del recv

        # 17a. K1r and K2r on the exact field's index, at B = 1 and 2 (the draws' batch):
        # every rank's rows checked, rank 0's and rank p/2's (their mirror images) timed
        index = grid_index(full)
        index_d = copy.deepcopy(index).to(dev)
        U, Pk = index.n_unique, index.n_packed
        full_idx = ce.expand_to_grid_plain(
            torch.arange(U, dtype=torch.float64), index, full).reshape(-1).to(dev, torch.int32)
        for B in (1, 2):
            batch = () if B == 1 else (B,)
            tab = torch.randn((U,) + batch, generator=g, device=dev)
            cot = torch.randn(full + batch, generator=g, device=dev)
            k1 = ce.expand_to_grid(tab, index_d, full)
            k2_ref = ce.collapse_from_grid_plain(cot.double().cpu(), index, full)
            for p in PARALLEL["ranks"]:
                b = n // p
                parts, k2_abs = 0, 0.0
                for r in range(p):
                    rows = (r * b, b)
                    if not torch.equal(ce.expand_to_grid_rows(tab, index_d, full, rows), k1[r * b:(r + 1) * b]):
                        fail(f"parallel: K1r differs from K1's rows {rows} at p={p}, B={B}")
                    cot_r = cot[r * b:(r + 1) * b]
                    part = ce.collapse_from_grid_rows(cot_r, index_d, full, rows)
                    if not torch.equal(part, ce.collapse_from_grid_rows(cot_r, index_d, full, rows)):
                        fail(f"parallel: K2r on rows {rows} at p={p}, B={B} differs from itself")
                    ref_r = ce.collapse_from_grid_rows_plain(cot_r.double(), index_d, full, rows)
                    k2_abs = max(k2_abs, float((part.double() - ref_r).abs().max()))
                    parts = parts + part.double().cpu()
                k2_err = rel_max(parts, k2_ref)
                if not k2_err <= TOL["k2"]:
                    fail(f"parallel: the K2r parts sum {k2_err} > {TOL['k2']} off K2 at p={p}, B={B}")
                for r in (0, p // 2):
                    rows, cot_r, idx_r = (r * b, b), cot[r * b:(r + 1) * b], full_idx[r * b * n:(r + 1) * b * n]
                    n_bytes = 4 * U * B + 4 * Pk + 4 * b * n * B
                    needed = int(ce.needed_packed(index_d, full, rows).sum())
                    k1r = timing(device_ms(lambda: ce.expand_to_grid_rows(tab, index_d, full, rows)),
                                 device_ms(lambda: ce.expand_to_grid_rows_plain(tab, index_d, full, rows)),
                                 n_bytes, library_ms=device_ms(lambda: tab.index_select(0, idx_r)))
                    k2r = timing(device_ms(lambda: ce.collapse_from_grid_rows(cot_r, index_d, full, rows)),
                                 device_ms(lambda: ce.collapse_from_grid_rows_plain(cot_r, index_d, full, rows)),
                                 n_bytes, library_ms=device_ms(lambda: tab.new_zeros((U,) + batch).index_add_(
                                     0, idx_r, cot_r.reshape((-1,) + batch))))
                    emit({"phase": "kernels", "kernel": "K1r+K2r", "shape": [n, n], "ranks": p, "rank": r,
                          "batch": B, "rows": b, "k1r_exact": True, "k2r_same_bits": True,
                          "k2r_parts_rel_err": k2_err, "needed_packed": needed,
                          "needed_bound_ms": bound(4 * U * B + 4 * needed + 4 * b * n * B)[0],
                          "range_table_bytes": index_d.row_tables(full, rows).nbytes(),
                          **{f"k1r_{k}": v for k, v in k1r.items()}, **{f"k2r_{k}": v for k, v in k2r.items()}})
                    if B == 1 and r == 0:
                        summary["K1r"] = dict(max_abs_err=0.0, ranks=p, **k1r)
                        summary["K2r"] = dict(max_abs_err=max(k2_abs, summary.get("K2r", {}).get("max_abs_err", 0.0)),
                                              ranks=p, **k2r)
            del tab, cot, k1
        del index_d, full_idx

        return x, H, scale

    def tomography_17c(mesh, vi, rel_pos, short):
        """17c: phase 13a's LOS cut to the rows of 2, 4 and 8 virtual ranks
        (partial ray sums and joined pull-backs against the whole), then
        on the group the row-sharded tomography metric against 13a's
        unsharded one and one MGVI iteration by ``position_sharding=``
        against the unsharded; 17d: ``optimize_kl`` with ``odir`` there,
        two iterations against one and a resume."""
        lh_t, start_np, tan_np = tomo["lh"], tomo["start_np"], tomo["tan_np"]
        los = lh_t.forward_model.outer
        n = los.domain.shape[0]
        pw, tw = (nt.position_from_numpy(lh_t.forward_model, v) for v in (start_np, tan_np))
        with torch.no_grad():
            rho = lh_t.forward_model.inner(pw)
        cot = torch.randn(tuple(los.target.shape), generator=g, device=dev)
        whole = los(rho)
        pull_whole = torch.func.vjp(los, rho)[1](cot)[0]
        t0 = time.perf_counter()
        virtual = {}
        for p in PARALLEL["ranks"]:
            b = n // p
            parts, pulls = 0, []
            for r in range(p):
                rows = rho[r * b:(r + 1) * b]
                parts = parts + los.rows_partial(rows, r * b)
                pulls.append(torch.func.vjp(lambda v, r=r: los.rows_partial(v, r * b), rows)[1](cot)[0])
            e_sum = float((parts - whole).abs().max()) / float(whole.abs().max())
            e_pull = float((torch.cat(pulls) - pull_whole).abs().max()) / float(pull_whole.abs().max())
            virtual[p] = {"ray_sums_rel_err": e_sum, "pull_backs_rel_err": e_pull,
                          "block_bytes": sum(t.table_bytes() for t in los.row_tables.values())}
            los.row_tables.clear()
            if not (e_sum <= TOL["los_rows"] and e_pull <= TOL["los_rows"]):
                fail(f"parallel: the LOS's row blocks over {p} ranks are {e_sum} (ray sums), "
                     f"{e_pull} (pull-backs) > {TOL['los_rows']} off the whole")
        virtual_s = time.perf_counter() - t0
        del parts, pulls, whole, pull_whole, rho, cot

        lh_s = sharded_tomography(lh_t, mesh)
        cf_s = lh_s.forward_model.inner.inner
        sh = cf_s.position_sharding()
        rows_keys = [k for k, v in sh.items() if v.split_axes()]
        ps, ts = (nt.position_from_numpy(cf_s, v, sharding=sh) for v in (start_np, tan_np))
        native.reset_launches()
        t0 = time.perf_counter()
        with parallel.field_sharded(mesh.get_group("fx"), rows_keys):
            ms = lh_s.metric(ps, ts)
            sync()
            first_s = time.perf_counter() - t0
            read_launches("parallel_tomography_metric", SHARDED, refuse=("K1", "K2", "K4"))
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                lh_s.metric(ps, ts)
                sync()
                times.append(1e3 * (time.perf_counter() - t0))
        ref = lh_t.metric(pw, tw)
        err = rel_pos(ms, ref)
        emit({"phase": "parallel_tomography", "shape": [n, n], "rays": int(los.target.shape[0]),
              "ranks": 1, "virtual_ranks": virtual, "virtual_s": virtual_s, "metric_first_s": first_s,
              "metric_apply_ms_median": float(np.median(times)), "metric_apply_ms_all": times,
              "rel_l2_vs_unsharded": err})
        if not err <= TOL["tomography_metric"]:
            fail(f"parallel: the sharded tomography metric {err} > {TOL['tomography_metric']}")
        del ms, ref, ts
        ref_short, _, ref_s = vi(lh_t, pw, short)
        native.reset_launches()
        got, st, secs = vi(lh_s, ps, short, position_sharding=sh)
        read_launches("parallel_tomography_vi", SHARDED, refuse=("K1", "K2", "K4"))
        err = rel_pos(got.pos, ref_short.pos)
        emit({"phase": "parallel_tomography_vi", "shape": [n, n], "ranks": 1, "by": "position_sharding",
              "settings": "CG 3", "seconds": secs, "unsharded_seconds": ref_s,
              "kl_after": float(st.minimization_state.fun), "rel_l2_vs_unsharded": err})
        if not (err <= TOL["sharded_vi"] and all(bool(torch.isfinite(v).all()) for v in got.pos.values())):
            fail(f"parallel: the sharded tomography MGVI iteration is {err} > {TOL['sharded_vi']} off")

        # 17d. optimize_kl with odir across the group: two iterations, and one then a resume
        native.reset_launches()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as od:
            runs = {}
            for name, iters in (("straight", (2,)), ("resumed", (1, 2))):
                for it in iters:
                    smp, st, _ = vi(lh_s, ps, short, n_total_iterations=it, position_sharding=sh,
                                    odir=os.path.join(od, name), resume=name == "resumed" and it == 2,
                                    export_operators={"field": cf_s})
                runs[name] = (smp, st, io.load_samples(os.path.join(od, name, "last.pkl"), "cpu"),
                              np.load(os.path.join(od, name, "operator_outputs", "field_last.npz")))
            secs = time.perf_counter() - t0
        read_launches("parallel_odir", SHARDED, refuse=("K1", "K2", "K4"))
        (a, st_a, file_a, exp_a), (b, st_b, file_b, exp_b) = runs["straight"], runs["resumed"]
        err = rel_pos(b.pos, a.pos)
        file_same = all(torch.equal(file_a.pos[k], a.pos[k].cpu()) for k in a.pos)
        exp_ok = exp_a["mean"].shape == (n, n) and bool(np.isfinite(exp_a["mean"]).all())
        emit({"phase": "parallel_odir", "shape": [n, n], "ranks": 1, "settings": "CG 3",
              "seconds": secs, "nit": [st_a.nit, st_b.nit], "rel_l2_resumed_vs_straight": err,
              "last_pkl_equals_gathered": file_same, "export_mean_shape": list(exp_a["mean"].shape),
              "export_rel_l2_resumed_vs_straight": float(
                  np.linalg.norm(exp_b["mean"] - exp_a["mean"]) / np.linalg.norm(exp_a["mean"]))})
        if not (st_a.nit == st_b.nit == 2 and err <= TOL["sharded_vi"] and file_same and exp_ok):
            fail(f"parallel: odir across the group: nit {st_a.nit}, {st_b.nit}, resumed {err} off, "
                 f"last.pkl the gathered samples {file_same}, export {exp_ok}")
        del lh_s, cf_s, ps, got, runs, a, b, file_a, file_b
        tomo.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def nuts_17e():
        """17e: phase 10's NUTS run with ``chain_map="pmap"`` on the group
        (its one rank takes every chain) against phase 10's ``"vmap"``
        chains."""
        lh_m, start, info_v = nuts["lh"], nuts["start"], nuts["info"]
        native.reset_launches()
        t0 = time.perf_counter()
        _, info = nt.nuts_sample(
            lh_m, MCMC["seed"], n_chains=MCMC["chains"], n_samples=MCMC["n_samples"],
            n_warmup=MCMC["n_warmup"], initial_position=start, max_tree_depth=MCMC["max_tree_depth"],
            step_size=MCMC["step_size"], chain_map="pmap")
        sync()
        secs = time.perf_counter() - t0
        read_launches("parallel_nuts_pmap", FIELD, batch=FIELD)
        got, want = info["chain_samples"], info_v["chain_samples"]
        num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
        err = (num / sum(float((want[k].double() ** 2).sum()) for k in want)) ** 0.5
        same_depths = torch.equal(info["tree_depths"].cpu(), info_v["tree_depths"].cpu())
        emit({"phase": "parallel_nuts_pmap", "ranks": 1, "chains": MCMC["chains"], "seconds": secs,
              "rel_l2_vs_vmap": err, "same_tree_depths": same_depths,
              "tree_depths": info["tree_depths"].tolist()})
        if not (same_depths and err <= TOL["chains"]):
            fail(f"parallel: pmap chains off the vmap ones: depths equal {same_depths}, "
                 f"relative L2 {err} > {TOL['chains']}")
        nuts.clear()

    t17 = time.perf_counter()
    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(PARALLEL["seed"])
    summary = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    for n in PARALLEL["shapes"]:
        x, H, scale = ranges_17a(n, g, summary, timing)
    ranges_17a_more(g)
    n = PARALLEL["shapes"][-1]

    # 17b. a one-rank group: NCCL on the card (gloo on the CPU)
    with tempfile.TemporaryDirectory() as tmp:
        parallel.initialize(os.path.join(tmp, "store"), 1, 0, device=dev.type)
        try:
            mesh = parallel.global_mesh(("fx",))
            native.reset_launches()
            t0 = time.perf_counter()
            hs = parallel.sharded_hartley2(x, mesh)
            sync()
            secs = time.perf_counter() - t0
            read_launches("parallel_hartley", ("K3", "K4r"), refuse=("K4",))
            err = float((hs - H).abs().max()) / scale
            emit({"phase": "parallel_hartley", "shape": [n, n], "ranks": 1,
                  "backend": dist.get_backend(), "seconds": secs, "rel_err_vs_hartley2d": err})
            if not err <= TOL["pencil"]:
                fail(f"parallel: sharded_hartley2 {err} > {TOL['pencil']} off hartley2d")
            del x, H, hs

            for knots in PARALLEL["metric_knots"]:
                variant = "exact" if knots is None else f"knot{knots}"
                lh, pos_np, tan_np = (built[n] if knots is None and n in (built or {}) else
                                      build_likelihood(n, dev, f32, n_mode_knots=knots))
                lhs, _, _ = build_likelihood(n, dev, f32, n_mode_knots=knots, field_mesh=mesh)
                sh = lhs.forward_model.inner.position_sharding()
                ps, ts = (nt.position_from_numpy(lhs.forward_model, v, sharding=sh)
                          for v in (pos_np, tan_np))
                native.reset_launches()
                t0 = time.perf_counter()
                ms = lhs.metric(ps, ts)
                sync()
                secs = time.perf_counter() - t0
                need = SHARDED if knots is None else ("K3", "K4r")
                read_launches(f"parallel_metric_{variant}", need,
                              refuse=("K1", "K2", "K4") + (() if knots is None else ("K1r", "K2r")))
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    lhs.metric(ps, ts)
                    sync()
                    times.append(1e3 * (time.perf_counter() - t0))
                ref = lh.metric(*(nt.position_from_numpy(lh.forward_model, v) for v in (pos_np, tan_np)))
                num = sum(float(((ms[k].double() - ref[k].double()) ** 2).sum()) for k in ref)
                err = (num / sum(float((ref[k].double() ** 2).sum()) for k in ref)) ** 0.5
                emit({"phase": "parallel_metric", "shape": [n, n], "variant": variant, "ranks": 1,
                      "first_s": secs, "metric_apply_ms_median": float(np.median(times)),
                      "metric_apply_ms_all": times, "rel_l2_vs_unsharded": err})
                if not err <= TOL["sharded_metric"]:
                    fail(f"parallel: the sharded {variant} metric {err} > {TOL['sharded_metric']}")
                del lh, lhs, ps, ts, ms, ref
                if dev.type == "cuda":
                    torch.cuda.empty_cache()

            nv = PARALLEL["vi"]
            lh_x, start_np = build_vi_likelihood(nv, dev, f32, None)
            lh_s, _ = build_vi_likelihood(nv, dev, f32, None, field_mesh=mesh)
            sh = lh_s.forward_model.inner.position_sharding()

            short = short_vi_settings()

            def vi(lh, pos, settings, n_total_iterations=1, **kw):
                t0 = time.perf_counter()
                smp, st = nt.optimize_kl(lh, pos, key=torch.Generator(device=dev).manual_seed(
                    PARALLEL["seed"]), n_total_iterations=n_total_iterations,
                    sample_mode="linear_resample", **settings, **kw)
                sync()
                return smp, st, time.perf_counter() - t0

            def rel_pos(a, b):
                num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
                return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5

            start = nt.position_from_numpy(lh_x.forward_model, start_np)
            ref, ref_st, ref_s = vi(lh_x, start, vi_settings())
            ref_short = vi(lh_x, start, short)[0]
            for name, lh, pos, kw, need, refuse in (
                ("position_sharding", lh_s,
                 nt.position_from_numpy(lh_s.forward_model, start_np, sharding=sh),
                 dict(position_sharding=sh), SHARDED + ("K7",), ("K1", "K2", "K4")),
                ("devices", lh_x, start, dict(devices=parallel.sample_mesh()), FIELD + ("K7",),
                 ("K1r", "K2r", "K4r")),
            ):
                native.reset_launches()
                smp, st, secs = vi(lh, pos, vi_settings(), **kw)
                read_launches(f"parallel_vi_{name}", need, refuse)
                kl_before = float(nt.OptimizeVI(lh, 1, **kw).kl_value_and_grad(
                    pos, primals_samples=smp)[0])
                err = rel_pos(smp.pos, ref.pos)
                err_short = rel_pos(vi(lh, pos, short, **kw)[0].pos, ref_short.pos)
                finite = all(bool(torch.isfinite(v).all()) for v in smp.pos.values())
                emit({"phase": "parallel_vi", "shape": [nv, nv], "variant": "exact", "ranks": 1,
                      "by": name, "seconds": secs, "unsharded_seconds": ref_s,
                      "kl_before": kl_before, "kl_after": float(st.minimization_state.fun),
                      "unsharded_kl_after": float(ref_st.minimization_state.fun),
                      "rel_l2_vs_unsharded": err, "rel_l2_vs_unsharded_cg3": err_short})
                if not (finite and float(st.minimization_state.fun) <= kl_before):
                    fail(f"parallel: the MGVI iteration by {name}: non-finite or the KL rose")
                if not err_short <= TOL["sharded_vi"]:
                    fail(f"parallel: the MGVI iteration by {name} (CG 3) is {err_short} > "
                         f"{TOL['sharded_vi']} off the unsharded one")
            del lh_x, lh_s, ref, ref_short, start
            if tomo is not None:
                tomography_17c(mesh, vi, rel_pos, short)
            if nuts is not None:
                nuts_17e()
            summary.update(large_phase(dev, read_launches, timing, mesh, vi, rel_pos, sync, g))
            learned_phase(dev, read_launches, mesh, vi, rel_pos, sync)
        finally:
            dist.destroy_process_group()
    emit({"phase": "parallel_total", "seconds": time.perf_counter() - t17})
    return summary


def large_phase(dev, read_launches, timing, mesh, vi, rel_pos, sync, g):
    """Phases 17f-g (``LARGE``), inside 17b's one-rank group ``mesh``: (f) the
    sharded NUFFT's stages over virtual ranks against ``nufft2`` and
    ``nufft_adjoint`` of the whole image (the joined pull-backs the same
    bits twice), then radio imaging on the group: the metric and energy of
    a Gaussian over ``nufft2(exp(cf(x)), coords)`` with the exact field
    (K1r, K2r, K3, K4r) against the unsharded one, and one MGVI iteration at
    CG 3 (K7 drawing its noise); (g) SKI's interpolation cut to the rows of
    virtual ranks against the whole matrix and, on the group, a SKI
    likelihood's metric against the unsharded one; K7 against its plain
    version (the words bit for bit, the normals to f32 rounding), a rank's
    rows of a draw against the whole draw's, and K7's time beside
    ``torch.randn``'s.  ``vi``, ``rel_pos`` and ``sync`` are 17b's; returns
    K7's kernel summary row."""
    import numpy as np
    import torch

    import nifty_tpu_torch as nt
    from nifty_tpu_torch import native, parallel
    from nifty_tpu_torch.bench.timing import device_ms
    from nifty_tpu_torch.bench.workload import bench_field, latent_draw, nufft_likelihood
    from nifty_tpu_torch.bench.workload import short_vi_settings
    from nifty_tpu_torch.ops import cuda_normal as cn
    from nifty_tpu_torch.ops.gather_reduce import GatherReduceT
    from nifty_tpu_torch.parallel.nufft import nufft_stages

    L, f32 = LARGE, torch.float32
    rng = np.random.default_rng(L["seed"])

    def event_ms(fn, reps=5):
        """The median ms of ``reps`` calls between CUDA events after a warm-up,
        host dispatch in (the NUFFT's steps copy and sort on the host)."""
        fn()
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))
    short = short_vi_settings()
    t17f = time.perf_counter()

    def on_group(name, lh_s, cf_s, lh, cf, start_np, tan_np, metric_tol):
        """The sharded likelihood's metric and energy inside the field context
        against the unsharded ones: the line's numbers."""
        sh = cf_s.position_sharding()
        rows = [k for k, v in sh.items() if v.split_axes()]
        ps, ts = (nt.position_from_numpy(cf_s, v, sharding=sh) for v in (start_np, tan_np))
        pw, tw = (nt.position_from_numpy(cf, v) for v in (start_np, tan_np))
        native.reset_launches()
        with parallel.field_sharded(mesh.get_group("fx"), rows):
            t0 = time.perf_counter()
            ms = lh_s.metric(ps, ts)
            sync()
            first_s = time.perf_counter() - t0
            read_launches(f"parallel_{name}_metric", SHARDED, refuse=("K1", "K2", "K4"))
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                lh_s.metric(ps, ts)
                sync()
                times.append(1e3 * (time.perf_counter() - t0))
            e_s = float(lh_s(ps))
        mf, e = lh.metric(pw, tw), float(lh(pw))
        err, e_err = rel_pos(ms, mf), abs(e_s - e) / abs(e)
        t0 = time.perf_counter()
        lh.metric(pw, tw)
        sync()
        line = {"metric_first_s": first_s, "metric_apply_ms_median": float(np.median(times)),
                "metric_apply_ms_all": times, "unsharded_metric_ms": 1e3 * (time.perf_counter() - t0),
                "rel_l2_vs_unsharded": err, "energy_rel_err": e_err}
        if not (err <= metric_tol and e_err <= metric_tol):
            fail(f"{name}: the sharded metric {err} / energy {e_err} > {metric_tol} off the unsharded")
        return line, sh, ps, pw

    # 17f. the sharded NUFFT's stages over virtual ranks
    n, m = L["nufft_shape"], L["nufft_points"]
    img = torch.complex(torch.randn((n, n), generator=g, device=dev),
                        torch.randn((n, n), generator=g, device=dev))
    coords = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, m)), device=dev, dtype=f32)
    cot = torch.complex(torch.randn(m, generator=g, device=dev), torch.randn(m, generator=g, device=dev))
    want, want_t = nt.nufft2(img, coords), nt.nufft_adjoint(cot, coords, (n, n))
    scale, scale_t = float(want.abs().max()), float(want_t.abs().max())
    unsharded = {"nufft2_ms": event_ms(lambda: nt.nufft2(img, coords)),
                 "nufft_adjoint_ms": event_ms(lambda: nt.nufft_adjoint(cot, coords, (n, n)))}
    virtual = {}
    for p in L["ranks"]:
        b = n // p
        t0 = time.perf_counter()
        st = nufft_stages((n, n), coords, p)
        for r in range(p):
            st.taps(r, dev, f32)
        build_s = time.perf_counter() - t0
        sent = [st.rows(img[None, r * b:(r + 1) * b], r) for r in range(p)]
        got = sum(st.cols([sent[r][s] for r in range(p)], s) for s in range(p))[0]
        recv0 = [sent[r][0].contiguous() for r in range(p)]  # what rank 0 receives
        del sent

        def pull(st=st, p=p, b=b):
            back = [st.cols_t(cot[None], s) for s in range(p)]
            return torch.cat([st.rows_t([back[s][r] for s in range(p)], r, False)
                              for r in range(p)], dim=1)[0]

        pulled = pull()
        same = torch.equal(pulled, pull())
        e_fwd = float((got - want).abs().max()) / scale
        e_adj = float((pulled - want_t).abs().max()) / scale_t
        back0 = [c.contiguous() for c in st.cols_t(cot[None], 0)]
        x0 = img[None, :b]
        virtual[p] = {"rows": b, "columns": st.bounds[1] - st.bounds[0], "tables_build_s": build_s,
                      "tables_bytes": st.table_bytes(), "forward_rel_err": e_fwd,
                      "adjoint_rel_err": e_adj, "pull_backs_same_bits": same,
                      "rank0_ms": {"rows": event_ms(lambda: st.rows(x0, 0)),
                                   "cols": event_ms(lambda: st.cols(recv0, 0)),
                                   "cols_t": event_ms(lambda: st.cols_t(cot[None], 0)),
                                   "rows_t": event_ms(lambda: st.rows_t(back0, 0, False))}}
        del st, got, pulled, recv0, back0
        if not (e_fwd <= TOL["nufft_stages"] and e_adj <= TOL["nufft_stages"] and same):
            fail(f"nufft over {p} virtual ranks: forward {e_fwd}, adjoint {e_adj} (> "
                 f"{TOL['nufft_stages']}?), the same bits twice {same}")
    emit({"phase": "parallel_nufft_stages", "shape": [n, n], "points": m, "oversampled": [2 * n, 2 * n],
          "virtual_ranks": virtual, "unsharded_ms": unsharded})
    del img, cot, want, want_t, coords
    torch.cuda.empty_cache()

    # 17f. radio imaging on the group: the exact field through exp and the sharded NUFFT
    lh, cf, _, start_np, tan_np = nufft_likelihood(n, m, dev, f32)
    lh_s, cf_s, _, _, _ = nufft_likelihood(n, m, dev, f32, field_mesh=mesh)
    line, sh, ps, pw = on_group("nufft", lh_s, cf_s, lh, cf, start_np, tan_np, TOL["nufft_metric"])
    ref, _, ref_s = vi(lh, pw, short)
    native.reset_launches()
    got, st, secs = vi(lh_s, ps, short, position_sharding=sh)
    read_launches("parallel_nufft_vi", SHARDED + ("K7",), refuse=("K1", "K2", "K4"))
    err, moved = rel_pos(got.pos, ref.pos), rel_pos(ref.pos, pw)
    # the step is ~2.5e-4 of the position: held against the step, not the position
    step = {k: ref.pos[k].double() - pw[k].double() for k in pw}
    err_step = rel_pos({k: got.pos[k].double() - pw[k].double() for k in pw}, step)
    emit({"phase": "parallel_nufft", "shape": [n, n], "points": m, "ranks": 1, **line,
          "vi_settings": "CG 3", "vi_seconds": secs, "unsharded_vi_seconds": ref_s,
          "vi_rel_l2_vs_unsharded": err, "vi_step_rel_l2": moved, "vi_err_over_step": err_step,
          "kl_after": float(st.minimization_state.fun), "seconds": time.perf_counter() - t17f})
    if not (err_step <= TOL["nufft_vi_step"]
            and all(bool(torch.isfinite(v).all()) for v in got.pos.values())):
        fail(f"nufft: the sharded MGVI iteration is {err_step} of the unsharded one's step "
             f"(> {TOL['nufft_vi_step']}) off it, or non-finite")
    del lh, cf, lh_s, cf_s, ps, pw, ref, got
    torch.cuda.empty_cache()

    # 17g. SKI's interpolation cut to the rows of virtual ranks, then on the group
    t17g = time.perf_counter()
    ns, mp = L["ski_grid"], L["ski_points"]
    pts = rng.uniform(0.0, 1.0, (2, mp))
    ski = nt.HarmonicSKI((ns, ns), [(0.0, 1.0)] * 2, pts, harmonic_kernel=lambda k: 1.0 / (
        1.0 + (k / 5.0) ** 2) ** 2, padding=0.5, device=dev, dtype=f32)
    w = ski.w
    x = torch.randn((ns, ns), generator=g, device=dev)
    y = torch.randn(mp, generator=g, device=dev)
    whole, pull_whole = w @ x.reshape(-1), w.T @ y
    ski_virtual = {}
    for p in L["ranks"]:
        b = ns // p
        parts = sum(w.rows_table(r * b, b) @ x[r * b:(r + 1) * b].reshape(-1) for r in range(p))
        pulls = torch.cat([GatherReduceT.apply(y, w.rows_table(r * b, b)) for r in range(p)])
        e_sum = float((parts - whole).abs().max()) / float(whole.abs().max())
        e_pull = float((pulls - pull_whole).abs().max()) / float(pull_whole.abs().max())
        ski_virtual[p] = {"partial_sums_rel_err": e_sum, "pull_backs_rel_err": e_pull,
                          "block_bytes": sum(t.table_bytes() for t in w.row_tables.values())}
        w.row_tables.clear()
        if not (e_sum <= TOL["ski_rows"] and e_pull <= TOL["ski_rows"]):
            fail(f"ski over {p} virtual ranks: partial sums {e_sum}, pull-backs {e_pull} > "
                 f"{TOL['ski_rows']}")
    del parts, pulls, whole, pull_whole, x, y

    def ski_lh(field_mesh):
        cf = bench_field(ns, dev, f32, field_mesh=field_mesh)
        with torch.no_grad():
            truth = bench_field(ns, dev, f32)(nt.position_from_numpy(cf, latent_draw(cf.domain, 0)))
            data = w @ torch.exp(truth).reshape(-1)
        data = data + 0.05 * torch.randn(mp, generator=torch.Generator(device=dev).manual_seed(5),
                                         device=dev)
        return nt.Gaussian(data, noise_std_inv=lambda r: r / 0.05).amend(
            lambda x: w @ torch.exp(cf(x)).reshape(-1)), cf

    (lh_s, cf_s), (lh, cf) = ski_lh(mesh), ski_lh(None)
    line, _, _, _ = on_group("ski", lh_s, cf_s, lh, cf, latent_draw(cf.domain, 2),
                             latent_draw(cf.domain, 3), TOL["nufft_metric"])
    emit({"phase": "parallel_ski", "grid": [ns, ns], "points": mp, "virtual_ranks": ski_virtual,
          "ranks": 1, **line})
    del ski, w, lh, lh_s, cf, cf_s

    # 17g. K7 against its plain version, a rank's rows against the whole draw, times
    N, key, leaf = L["k7_entries"], 2**61 + 12345, 3
    words_same = torch.equal(cn.philox_words(key, leaf, 0, N, dev),
                             cn.philox_words_plain(key, leaf, 0, N, dev))
    z = cn.philox_normal(key, leaf, 0, N, f32, dev)
    zp = cn.philox_normal_plain(key, leaf, 0, N, f32, dev)
    err = float((z - zp).abs().max()) / float(zp.abs().max())
    abs_err = float((z - zp).abs().max())
    moments = [float(z.double().mean()), float(z.double().var())]
    del zp
    n64 = L["k7_f64_entries"]
    z64 = cn.philox_normal(key, leaf, 0, n64, torch.float64, dev)
    err64 = float((z64 - cn.philox_normal_plain(key, leaf, 0, n64, torch.float64, dev)).abs().max()
                  / z64.abs().max())
    del z64
    nr = L["k7_rows"]
    draw = cn.philox_normal(key, leaf, 0, nr * nr, f32, dev)
    rows_same = all(torch.equal(cn.philox_normal(key, leaf, r * (nr // p) * nr, (nr // p) * nr, f32, dev),
                                draw[r * (nr // p) * nr:(r + 1) * (nr // p) * nr])
                    for p in L["ranks"] for r in range(p))
    rows_same = rows_same and torch.equal(cn.philox_normal(key, leaf, 4099, 12345, f32, dev),
                                          draw[4099:4099 + 12345])
    del draw
    k7_ms = device_ms(lambda: cn.philox_normal(key, leaf, 0, N, f32, dev))
    plain_ms = device_ms(lambda: cn.philox_normal_plain(key, leaf, 0, N, f32, dev), iters=2, warmup=1)
    randn_ms = device_ms(lambda: torch.randn(N, device=dev))
    # 4 bytes written an entry; per pair of entries a log, a sqrt and a sincospi (~40 f32
    # operations each as the accurate functions evaluate them) and the Philox rounds
    k7 = timing(k7_ms, plain_ms, 4 * N, flops=60.0 * N, library_ms=randn_ms)
    issue = {}
    if dev.type == "cuda":  # the issue bound beside the byte bound: SASS of the built library
        from nifty_tpu_torch.bench.sharded_kernels_bench import k7_issue_bound

        issue = k7_issue_bound(native.build(), N)
    emit({"phase": "kernels", "kernel": "K7", "entries": N, "words_same_bits": words_same,
          "normals_rel_err": err, "f64_rel_err": err64, "rank_rows_same_bits": rows_same,
          "mean_var": moments, "seconds": time.perf_counter() - t17g, **k7, **issue})
    if not (words_same and rows_same and err <= TOL["k7"] and err64 <= TOL["k7_f64"]):
        fail(f"K7: words the same bits {words_same}, rank rows the same bits {rows_same}, "
             f"normals {err} (> {TOL['k7']}?), f64 {err64} (> {TOL['k7_f64']}?)")
    torch.cuda.empty_cache()
    return {"K7": dict(max_abs_err=abs_err, entries=N, **k7)}


def learned_phase(dev, read_launches, mesh, vi, rel_pos, sync):
    """Phase 17h (``LEARNED``), inside 17b's one-rank group ``mesh``: radio
    imaging with learned coordinates, ``VariablePositionNufft`` of the exact
    field's exp at ``base + 1e-4 uv`` (``uv`` a replicated latent): its
    metric and energy on the group against the unsharded (K1r, K2r, K3,
    K4r), the ms of cutting a position's taps (weights and derivatives) on
    the card, and one MGVI iteration at CG 3 over 4 mirrored sample pairs
    (K7 drawing its noise) against the unsharded one's step, with its peak
    memory, the taps it cut and the plans' memory held after it; 17f's stages at points whose shares differ by
    one (the ranks' partial outputs against ``nufft2``, the joined
    pull-backs against ``nufft_adjoint``, the reduce-scatter's padded
    blocks against ``np.array_split``'s shares); the light cone on a
    row-split latent, cut to 2, 4 and 8 virtual ranks' rows (the ranks'
    gather stood in by the whole latent) and on the group (value and
    pull-back), against the unsharded, with its time and its peak memory
    on the card.  ``vi``, ``rel_pos`` and ``sync`` are 17b's."""
    from unittest import mock

    import numpy as np
    import torch

    import nifty_tpu_torch as nt
    from nifty_tpu_torch import native, parallel
    from nifty_tpu_torch.bench.workload import latent_draw, learned_nufft_likelihood
    from nifty_tpu_torch.bench.workload import learned_position, short_vi_settings
    from nifty_tpu_torch.parallel import NamedSharding, collectives
    from nifty_tpu_torch.parallel.nufft import NufftPlan, nufft_stages, taps_cut

    L, f32 = LEARNED, torch.float32
    rng = np.random.default_rng(L["seed"])
    g = torch.Generator(device=dev).manual_seed(L["seed"])
    t17h = time.perf_counter()
    n, m = L["nufft_shape"], L["nufft_points"]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    # 17h. the learned coordinates: metric and energy on the group against the unsharded
    lh, cf, base, start_np, tan_np = learned_nufft_likelihood(n, m, dev, f32)
    lh_s, cf_s, _, _, _ = learned_nufft_likelihood(n, m, dev, f32, field_mesh=mesh)
    sh = {**cf_s.position_sharding(), "uv": NamedSharding(mesh, ())}
    rows = [k for k, v in sh.items() if v.split_axes()]
    ps, ts = (learned_position(cf_s, v, dev, f32, sh) for v in (start_np, tan_np))
    pw, tw = (learned_position(cf, v, dev, f32) for v in (start_np, tan_np))
    native.reset_launches()
    with parallel.field_sharded(mesh.get_group("fx"), rows):
        ms, first_ms = timed(lambda: lh_s.metric(ps, ts))
        read_launches("parallel_learned_metric", SHARDED, refuse=("K1", "K2", "K4"))
        times = [timed(lambda: lh_s.metric(ps, ts))[1] for _ in range(3)]
        e_s = float(lh_s(ps))
    mf, unsharded_ms = timed(lambda: lh.metric(pw, tw))
    e = float(lh(pw))
    err, e_err = rel_pos(ms, mf), abs(e_s - e) / abs(e)
    del ms, mf
    # the taps of a new primal position (a plan cut once a position): weights, the CSR
    # transpose and the derivative tables, sorted on the card
    cuts, table_bytes = [], 0
    for i in range(L["taps_cuts"]):
        coords = base + 1e-4 * (ps["uv"] + 0.01 * (i + 1))
        taps, cut_ms = timed(lambda: NufftPlan((n, n), coords, 1).taps(0, dev, f32, deriv=True))
        cuts.append(cut_ms)
        table_bytes = taps.nbytes()
        del taps
    line = {"metric_first_ms": first_ms, "metric_apply_ms_median": float(np.median(times)),
            "metric_apply_ms_all": times, "unsharded_metric_ms": unsharded_ms,
            "rel_l2_vs_unsharded": err, "energy_rel_err": e_err,
            "taps_cut_ms_median": float(np.median(cuts)), "taps_cut_ms_all": cuts,
            "taps_bytes": table_bytes}
    if not (err <= TOL["learned_metric"] and e_err <= TOL["learned_metric"]):
        fail(f"learned coordinates: the sharded metric {err} / energy {e_err} > "
             f"{TOL['learned_metric']} off the unsharded")

    # 17h. one MGVI iteration at CG 3 over 4 mirrored sample pairs on the group against the
    # unsharded; the taps it cuts (the model keeps a plan for each set of coordinates a KL
    # evaluation maps) and the memory they hold
    short = dict(short_vi_settings(), n_samples=L["vi_samples"])
    ref, _, ref_s = vi(lh, pw, short)
    card = dev.type == "cuda"
    sync()
    mem0 = torch.cuda.memory_allocated() if card else 0
    if card:
        torch.cuda.reset_peak_memory_stats()
    cut0 = taps_cut()
    native.reset_launches()
    got, st, secs = vi(lh_s, ps, short, position_sharding=sh)
    read_launches("parallel_learned_vi", SHARDED + ("K7",), refuse=("K1", "K2", "K4"))
    vi_cuts = taps_cut() - cut0
    step = {k: ref.pos[k].double() - pw[k].double() for k in pw}
    err_step = rel_pos({k: got.pos[k].double() - pw[k].double() for k in pw}, step)
    kl_after = float(st.minimization_state.fun)
    step_rel = rel_pos(ref.pos, pw)
    finite = all(bool(torch.isfinite(v).all()) for v in got.pos.values())
    del got, st, ref
    sync()
    mem = {"vi_peak_mb": (torch.cuda.max_memory_allocated() - mem0) / 2**20 if card else None,
           "plans_held_mb_after_vi": (torch.cuda.memory_allocated() - mem0) / 2**20 if card else None}
    emit({"phase": "parallel_learned", "shape": [n, n], "points": m, "ranks": 1, **line,
          "vi_settings": "CG 3", "vi_samples": 2 * L["vi_samples"], "vi_seconds": secs,
          "unsharded_vi_seconds": ref_s, "vi_taps_cut": vi_cuts, **mem,
          "vi_err_over_step": err_step, "vi_step_rel_l2": step_rel,
          "kl_after": kl_after, "seconds": time.perf_counter() - t17h})
    if not (err_step <= TOL["learned_vi_step"] and finite):
        fail(f"learned coordinates: the sharded MGVI iteration is {err_step} of the unsharded "
             f"one's step (> {TOL['learned_vi_step']}) off it, or non-finite")
    del lh, cf, lh_s, cf_s, ps, ts, pw, tw, base  # the plans go with the likelihood
    torch.cuda.empty_cache()

    # 17h. 17f's stages at points whose shares differ by one
    t0 = time.perf_counter()
    mu = L["uneven_points"]
    img = torch.complex(torch.randn((n, n), generator=g, device=dev),
                        torch.randn((n, n), generator=g, device=dev))
    coords = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, mu)), device=dev, dtype=f32)
    cot = torch.complex(torch.randn(mu, generator=g, device=dev), torch.randn(mu, generator=g, device=dev))
    want, want_t = nt.nufft2(img, coords), nt.nufft_adjoint(cot, coords, (n, n))
    scale, scale_t = float(want.abs().max()), float(want_t.abs().max())
    uneven = {}
    for p in L["ranks"]:
        b = n // p
        st_ = nufft_stages((n, n), coords, p)
        sent = [st_.rows(img[None, r * b:(r + 1) * b], r) for r in range(p)]
        total = sum(st_.cols([sent[r][s] for r in range(p)], s) for s in range(p))[0]
        del sent
        blocks = collectives._padded(total, p)  # the reduce-scatter's send buffer
        shares = [blocks[r][: len(part)] for r, part in enumerate(np.array_split(np.arange(mu), p))]
        exact = all(torch.equal(sh_, total[int(part[0]):int(part[-1]) + 1]) for sh_, part in
                    zip(shares, np.array_split(np.arange(mu), p)))
        exact = exact and torch.equal(collectives._unpadded(blocks, mu), total)
        back = [st_.cols_t(cot[None], s) for s in range(p)]
        pulled = torch.cat([st_.rows_t([back[s][r] for s in range(p)], r, False) for r in range(p)], dim=1)[0]
        e_fwd = float((total - want).abs().max()) / scale
        e_adj = float((pulled - want_t).abs().max()) / scale_t
        uneven[p] = {"shares": sorted({len(x) for x in np.array_split(np.arange(mu), p)}),
                     "forward_rel_err": e_fwd, "adjoint_rel_err": e_adj, "padded_shares_exact": exact}
        del st_, total, blocks, shares, back, pulled
        if not (e_fwd <= TOL["nufft_stages"] and e_adj <= TOL["nufft_stages"] and exact):
            fail(f"nufft at {mu} points over {p} virtual ranks: forward {e_fwd}, adjoint {e_adj} "
                 f"(> {TOL['nufft_stages']}?), the padded shares exact {exact}")
    emit({"phase": "parallel_nufft_uneven", "shape": [n, n], "points": mu, "virtual_ranks": uneven,
          "seconds": time.perf_counter() - t0})
    del img, coords, cot, want, want_t
    torch.cuda.empty_cache()

    # 17h. the light cone on a row-split latent: virtual ranks, then the group
    t0 = time.perf_counter()
    shape = L["dynamics"]
    dyn, _ = nt.dynamic_lightcone_operator(
        shape=shape, distances=(1.0 / shape[0], 1.0 / shape[1]), key="dyn", lightcone_key="speed",
        sm_s0=1.0, sm_x0=(8.0, 8.0), sigc=0.3, quant=2.0, harmonic_padding=L["dynamics_padding"])
    lat = {k: torch.as_tensor(v, device=dev, dtype=f32) for k, v in latent_draw(dyn.domain, 4).items()}
    ct = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape), device=dev,
                         dtype=torch.complex64)
    whole, pull = torch.func.vjp(dyn, lat)
    gw = pull(ct)[0]
    top = float(whole.abs().max())
    pshape, virtual = dyn.domain["dyn"].shape, {}
    native.reset_launches()
    for p in L["ranks"]:
        errs = []
        for r in range(p):  # rank r's rows of the latent; the gather stood in by the whole latent
            part = {"dyn": lat["dyn"][r * pshape[0] // p:(r + 1) * pshape[0] // p], "speed": lat["speed"]}
            with mock.patch.object(torch.distributed, "get_world_size", lambda group=None, p=p: p), \
                    mock.patch.object(torch.distributed, "get_rank", lambda group=None, r=r: r), \
                    mock.patch.object(collectives, "all_gather", lambda x, *a, **k: lat["dyn"]), \
                    parallel.field_sharded(mesh.get_group("fx"), ["dyn"]):
                y = dyn(part)
            lo, hi = collectives.share(shape[0], p, r)
            errs.append(float((y - whole[lo:hi]).abs().max()) / top if y.shape[0] == hi - lo else float("inf"))
        virtual[p] = max(errs)
    sync()
    mem0 = torch.cuda.memory_allocated() if card else 0
    if card:
        torch.cuda.reset_peak_memory_stats()
    with parallel.field_sharded(mesh.get_group("fx"), ["dyn"]):
        y, pull_s = torch.func.vjp(dyn, lat)  # the latent's rows gathered, the whole computed
        gs = pull_s(ct)[0]
        sync()
        peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2**20 if card else None
        cone_ms = [timed(lambda: dyn(lat))[1] for _ in range(5)]
    read_launches("parallel_dynamics", (), refuse=tuple(NAMES))
    plain_ms = [timed(lambda: dyn(lat))[1] for _ in range(5)]
    group_err = {"value": float((y - whole).abs().max()) / top,
                 "pull_back_dyn": float((gs["dyn"] - gw["dyn"]).abs().max()) / float(gw["dyn"].abs().max()),
                 "pull_back_speed": float((gs["speed"] - gw["speed"]).abs().max()) / float(gw["speed"].abs().max())}
    emit({"phase": "parallel_dynamics", "shape": list(shape), "padding": list(L["dynamics_padding"]),
          "virtual_ranks_rel_err": virtual, "group_rel_err": group_err, "peak_mb": peak_mb,
          "latent_mb": lat["dyn"].numel() * 4 / 2**20, "ms_median": float(np.median(cone_ms)),
          "unsharded_ms_median": float(np.median(plain_ms)), "seconds": time.perf_counter() - t0})
    bad = [e for e in list(virtual.values()) + list(group_err.values()) if not e <= TOL["cone_rows"]]
    if bad:
        fail(f"the light cone on a row-split latent: {virtual}, {group_err} beyond {TOL['cone_rows']}")
    emit({"phase": "parallel_learned_total", "seconds": time.perf_counter() - t17h})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import nifty_tpu_torch as nt
    from nifty_tpu_torch import native
    from nifty_tpu_torch.ops import cuda_expand as ce
    from nifty_tpu_torch.bench.timing import bound, device_ms, fft_flops
    from nifty_tpu_torch.bench.workload import (
        bench_field, build_likelihood, build_vi_likelihood, density_counts, grid_index,
        latent_draw, leapfrog_energy_change, legendre_bmm_operands, legendre_table, matern_field,
        ndvcg_forward, poisson_at_own_draw,
        tomography, tomography_rays, vi_settings, sphere_field, sphere_index, gaussian_at_own_draw,
        icr_fields)
    from nifty_tpu_torch.hmc_oo import Potential, Ravel
    from nifty_tpu_torch.evidence_lower_bound import _ravel_metric
    from nifty_tpu_torch.ops import cuda_fft as cfft
    from nifty_tpu_torch.optimize_kl import _kl_met, _kl_vg
    from nifty_tpu_torch.utils.tree_linalg import EIGH_CHUNK, _eigh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    native.build(verbose=True)
    native.lib()
    build_s = time.perf_counter() - t0
    print(native.build_log(), file=sys.stderr)
    t0 = time.perf_counter()
    card = {n: build_likelihood(n, dev, torch.float32) for n in SHAPES_MAIN}
    ref64 = build_likelihood(SHAPES_MAIN[0], "cpu", torch.float64)
    model_s = time.perf_counter() - t0
    emit({"phase": "build", "nvcc_s": build_s, "models_s": model_s})

    # -- 3. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    def record(key, err, times=None):
        s = summary.setdefault(key, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s.update(times or {})  # the last (largest) main-path shape's times at B = 1

    def timing(ms, plain_ms, n_bytes, flops=0.0, library_ms=None, flops64=0.0):
        b_ms, b_by = bound(n_bytes, flops, flops64)
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms}

    def k1k2_rows(label, index, index_d, full, keep_times):
        """K1 and K2 on ``index`` (on the CPU) / ``index_d`` (on the card) at
        B = 1, 2 and 4: K1 bit-equal to its plain version and to
        ``index_select`` over the full-grid index, K2 the same bits twice
        and within TOL["k2"] of float64 on the CPU; times beside them."""
        U, P, N = index.n_unique, index.n_packed, int(np.prod(full))
        # the yardsticks' full-grid int32 index, made once for them only
        full_idx = ce.expand_to_grid_plain(
            torch.arange(U, dtype=torch.float64), index, full).reshape(-1).to(dev, torch.int32)
        for B in (1, 2, 4):
            batch = () if B == 1 else (B,)
            tab = torch.randn((U,) + batch, generator=g, device=dev)
            out = ce.expand_to_grid(tab, index_d, full)
            if not torch.equal(out, ce.expand_to_grid_plain(tab, index_d, full)):
                fail(f"K1 differs from its plain version at {label} B={B}")
            if not torch.equal(out.reshape((N,) + batch), tab.index_select(0, full_idx)):
                fail(f"K1 differs from tab[full_idx] at {label} B={B}")
            n_bytes = 4 * U * B + 4 * P + 4 * N * B  # table, packed index, grid
            k1 = timing(device_ms(lambda: ce.expand_to_grid(tab, index_d, full)),
                        device_ms(lambda: ce.expand_to_grid_plain(tab, index_d, full)),
                        n_bytes,
                        library_ms=device_ms(lambda: tab.index_select(0, full_idx)))
            cot = torch.randn(full + batch, generator=g, device=dev)
            seg = ce.collapse_from_grid(cot, index_d, full)
            if not torch.equal(seg, ce.collapse_from_grid(cot, index_d, full)):
                fail(f"K2 is not deterministic at {label} B={B}")
            seg_ref = ce.collapse_from_grid_plain(cot.double().cpu(), index, full)
            k2_err = rel_max(seg.double().cpu(), seg_ref)
            if not k2_err <= TOL["k2"]:
                fail(f"K2 relative error {k2_err} > {TOL['k2']} at {label} B={B}")
            k2_abs = float((seg.double().cpu() - seg_ref).abs().max())
            cot_flat = cot.reshape((N,) + batch)
            k2 = timing(device_ms(lambda: ce.collapse_from_grid(cot, index_d, full)),
                        device_ms(lambda: ce.collapse_from_grid_plain(cot, index_d, full)),
                        n_bytes,
                        library_ms=device_ms(lambda: cot.new_zeros((U,) + batch).index_add_(
                            0, full_idx, cot_flat)))
            emit({"phase": "kernels", "kernel": "K1+K2", "layout": label,
                  "kind": index.layout.kind, "B": B, "P": P, "U": U, "N": N,
                  "large_bins": int(index.large_bins.numel()),
                  "largest_bin": int((index.offsets[1:] - index.offsets[:-1]).max()),
                  "k1_exact": True, **{f"k1_{k}": v for k, v in k1.items()},
                  "k2_rel_err": k2_err, **{f"k2_{k}": v for k, v in k2.items()}})
            record("K1", 0.0, k1 if keep_times and B == 1 else None)
            record("K2", k2_abs, k2 if keep_times and B == 1 else None)
            del out, cot, cot_flat, seg
        del full_idx
        torch.cuda.empty_cache()

    for n in (VI_SHAPE,) + SHAPES_MAIN:  # ascending: the summary keeps 4096²'s times
        full = (n, n)
        if n in card:
            index_d = card[n][0].forward_model.inner.indexes[0]
            index = copy.deepcopy(index_d).to("cpu")
        else:  # the exact geoVI grid of phase 8, as its model's finalize() builds it
            index = grid_index(full)
            index_d = copy.deepcopy(index).to(dev)
        k1k2_rows(f"{n}x{n}_exact", index, index_d, full, True)
        del index_d
    # the spherical field's own index (phase 14's nside), as its finalize() builds
    # it: a flat 1-D layout onto the packed alm, bins of up to 2l + 1 members
    index = sphere_index(SPHERE["field"])
    k1k2_rows(f"sphere_nside{SPHERE['field']}_flat", index, copy.deepcopy(index).to(dev),
              tuple(index.layout.core_shape), False)

    for n in SHAPES_HARTLEY:
        x = torch.randn((n, n), generator=g, device=dev)
        G = cfft.hartley_rows(x)
        Gp = cfft.hartley_rows_plain(x)
        e3 = rel_max(G, Gp)
        Gp_pad = cfft.padded_half_spectrum(Gp)
        H = cfft.hartley_cols(Gp_pad, n)
        Hp = cfft.hartley_cols_plain(Gp, n)
        e4 = rel_max(H, Hp)
        full = cfft.hartley2d(x)
        e_full = rel_max(full, Hp)
        e_inv = rel_max(cfft.hartley2d(full) / x.numel(), x)
        for what, err in (("K3", e3), ("K4", e4), ("K3+K4", e_full), ("H(H(x))/N", e_inv)):
            if not err <= TOL["hartley"]:
                fail(f"{what} relative error {err} > {TOL['hartley']} at {n}²")
        h = n // 2 + 1
        io_bytes = 4 * n * n + 8 * n * h  # one real array and one half spectrum
        rfft_ms = device_ms(lambda: cfft.hartley_rows_plain(x))  # plain K3 is rfft itself
        k3 = timing(device_ms(lambda: cfft.hartley_rows(x)), rfft_ms,
                    io_bytes, fft_flops(n, n // 2), library_ms=rfft_ms)
        k4 = timing(device_ms(lambda: cfft.hartley_cols(Gp_pad, n)),
                    device_ms(lambda: cfft.hartley_cols_plain(Gp, n)),
                    io_bytes, fft_flops(n, h))
        emit({"phase": "kernels", "kernel": "K3+K4", "shape": [n, n],
              "k3_rel_err": e3, "k4_rel_err": e4, "hartley_rel_err": e_full,
              "inverse_rel_err": e_inv, **{f"k3_{k}": v for k, v in k3.items()},
              **{f"k4_{k}": v for k, v in k4.items()}})
        if n in SHAPES_MAIN or n == VI_SHAPE:
            record("K3", float((G - Gp).abs().max()), k3)
            record("K4", float((H - Hp).abs().max()), k4)
        del x, G, Gp, Gp_pad, H, Hp, full
        torch.cuda.empty_cache()

    for n, B in ((n, B) for n in SHAPES_HARTLEY_BATCH for B in (2, 4)):
        # the batches of the VI phases (2 keys, 4 samples): one launch pair for B grids
        x = torch.randn((B, n, n), generator=g, device=dev)
        G = cfft.hartley_rows(x)
        Gp = cfft.hartley_rows_plain(x)
        e3 = rel_max(G, Gp)
        Gp_pad = cfft.padded_half_spectrum(Gp)
        H = cfft.hartley_cols(Gp_pad, n)
        Hp = cfft.hartley_cols_plain(Gp, n)
        e4 = rel_max(H, Hp)
        for what, err in (("batched K3", e3), ("batched K4", e4)):
            if not err <= TOL["hartley"]:
                fail(f"{what} relative error {err} > {TOL['hartley']} at {B}x{n}²")
        h = n // 2 + 1
        io_bytes = B * (4 * n * n + 8 * n * h)
        rfft_ms = device_ms(lambda: cfft.hartley_rows_plain(x))
        k3 = timing(device_ms(lambda: cfft.hartley_rows(x)), rfft_ms,
                    io_bytes, fft_flops(n, B * n // 2), library_ms=rfft_ms)
        k4 = timing(device_ms(lambda: cfft.hartley_cols(Gp_pad, n)),
                    device_ms(lambda: cfft.hartley_cols_plain(Gp, n)),
                    io_bytes, fft_flops(n, B * h))
        emit({"phase": "kernels", "kernel": "K3+K4", "shape": [B, n, n],
              "k3_rel_err": e3, "k4_rel_err": e4, **{f"k3_{k}": v for k, v in k3.items()},
              **{f"k4_{k}": v for k, v in k4.items()}})
        record("K3", float((G - Gp).abs().max()))
        record("K4", float((H - Hp).abs().max()))
        del x, G, Gp, Gp_pad, H, Hp
        torch.cuda.empty_cache()

    # -- 4. main path -----------------------------------------------------
    def rel_l2(got, ref):
        """Relative L2 of ``got`` (on the card) against ``ref`` (on the CPU),
        dicts of tensors or of lists of them (an ICR field's levels)."""
        pairs = [(a, b) for k in ref for a, b in zip(torch.utils._pytree.tree_leaves(got[k]),
                                                     torch.utils._pytree.tree_leaves(ref[k]))]
        num = sum(float(((a.double().cpu() - b) ** 2).sum()) for a, b in pairs)
        return (num / sum(float((b**2).sum()) for _, b in pairs)) ** 0.5

    def event_ms(fn, reps):
        """The ms of each of ``reps`` calls between CUDA events, host dispatch in."""
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return times

    def metric_phase(phase, variant, n, lh, pos_np, tan_np, lh64=None):
        """Apply the metric once (checked) and 10 times (timed) and emit the
        line; return the position and tangent on the card."""
        torch.cuda.reset_peak_memory_stats()
        p = nt.position_from_numpy(lh.forward_model, pos_np)  # the model's device and dtype
        t = nt.position_from_numpy(lh.forward_model, tan_np)
        m = lh.metric(p, t)
        torch.cuda.synchronize()
        for k, v in m.items():
            if v.shape != t[k].shape or v.device != dev or not bool(torch.isfinite(v).all()):
                fail(f"{variant} metric leaf {k} at {n}²: shape {tuple(v.shape)}, {v.device} or non-finite")
        times = event_ms(lambda: lh.metric(p, t), 10)
        line = {"phase": phase, "shape": [n, n], "variant": variant, "dtype": "float32",
                "metric_apply_ms_median": float(np.median(times)), "metric_apply_ms_all": times,
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if lh64 is not None:
            ref = lh64.metric(nt.position_from_numpy(lh64.forward_model, pos_np),
                              nt.position_from_numpy(lh64.forward_model, tan_np))
            line["rel_l2_vs_cpu_f64"] = err = rel_l2(m, ref)
            if not err <= TOL["metric"]:
                fail(f"{variant} metric at {n}²: relative L2 {err} > {TOL['metric']} against CPU f64")
        emit(line)
        return p, t

    @torch.no_grad()
    def hamiltonian_f32_sums(lh, q, p):
        """The Poisson posterior's H(q, p), unit mass, every sum in float32:
        the reading of the energies' rounding before they summed in float64."""
        lam = lh.forward_model(q)
        energy = lam.sum() - (torch.log(lam) * lh.likelihood.data).sum()
        return float(energy + 0.5 * sum((v * v).sum() for v in list(q.values()) + list(p.values())))

    launches, batched = {}, {}  # phase -> {kernel wrapper: launches (with a batch > 1)}

    def read_launches(phase, need, refuse=(), batch=()):
        """The phase's launches since the counters were last set to 0: every
        kernel of ``need`` launched, none of ``refuse``, and every kernel
        of ``batch`` launched on a batch of samples at least once."""
        launches[phase] = counts = dict(native.launches)
        batched[phase] = dict(native.batched_launches)
        missing = [k for k in need if counts.get(NAMES[k], 0) == 0]
        stray = [k for k in refuse if counts.get(NAMES[k], 0)]
        unbatched = [k for k in batch if batched[phase].get(NAMES[k], 0) == 0]
        if missing or stray or unbatched:
            fail(f"{phase}: kernels not launched {missing}, launched but off the path {stray}, "
                 f"never on a batch {unbatched} (counts {counts}, batched {batched[phase]})")

    native.reset_launches()
    for n in SHAPES_MAIN:
        lh, pos_np, tan_np = card.pop(n)
        ref = ref64[0] if n == SHAPES_MAIN[0] else None
        p, t = metric_phase("main_path", "exact", n, lh, pos_np, tan_np, ref)
        if n == SHAPES_MAIN[0]:
            lh_small, p_small, t_small = lh, p, t
        del lh, p, t
        torch.cuda.empty_cache()
    read_launches("main_path", FIELD)

    # -- 5. a few CG steps: (M + 1) x = b at 1280² -------------------------
    def mat(x):
        mx = lh_small.metric(p_small, x)
        return {k: mx[k] + x[k] for k in x}

    b = t_small
    b_norm = float(nt.norm(b))

    def residual(n_iter):
        x = nt.cg(mat, b, maxiter=n_iter, miniter=n_iter, absdelta=0.0).x
        r = mat(x)
        return float(nt.norm({k: r[k] - b[k] for k in b})) / b_norm

    # CG guarantees a falling energy (cg raises if it rises); the residual
    # norm of an ill-conditioned system first jumps and then falls, so it
    # is held against the residual after the first iteration
    native.reset_launches()
    first = residual(1)
    t0 = time.perf_counter()
    last = residual(CG_ITERS)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    read_launches("cg", FIELD)
    emit({"phase": "cg", "shape": [SHAPES_MAIN[0]] * 2, "iterations": CG_ITERS,
          "residual_over_rhs_after_1": first, f"residual_over_rhs_after_{CG_ITERS}": last,
          "seconds": cg_s})
    if not last < first:
        fail(f"CG residual did not fall: {last} after {CG_ITERS} iterations, {first} after 1")
    del lh_small, p_small, t_small, b
    torch.cuda.empty_cache()

    # -- 6. the 64-knot metric apply ------------------------------------------
    knot64 = build_likelihood(SHAPES_KNOT[0], "cpu", torch.float64, n_mode_knots=KNOTS)[0]
    native.reset_launches()
    for n in SHAPES_KNOT:
        t0 = time.perf_counter()
        lh, pos_np, tan_np = build_likelihood(n, dev, torch.float32, n_mode_knots=KNOTS)
        emit({"phase": "knot_build", "shape": [n, n], "seconds": time.perf_counter() - t0})
        ref = knot64 if n == SHAPES_KNOT[0] else None
        metric_phase("knot", f"knot{KNOTS}", n, lh, pos_np, tan_np, ref)
        del lh, pos_np, tan_np
        torch.cuda.empty_cache()
    read_launches("knot", ("K3", "K4"), refuse=("K1", "K2"))
    del knot64

    # -- 7. one MGVI and one geoVI iteration at 1024² knot64 -------------------
    def count():
        return {k: native.launches.get(NAMES[k], 0) for k in NAMES}

    def vi_phase(phase, need, refuse, opt_vi, start, mode, seed, runs, maps, **extra):
        """``runs`` iterations of ``opt_vi.update`` from ``start`` (the first a
        warm-up when there are more), each checked; emits the line and
        returns the last samples and the last iteration's launches.  The
        launch counters are set to 0 just before and read just after: the
        kernels of ``need`` must have launched in this run, and in its last
        iteration, under ``vmap`` on batches of samples, under ``lmap`` on
        one sample at a time."""
        native.reset_launches()
        state = opt_vi.init_state(torch.Generator(device=dev).manual_seed(seed),
                                  sample_mode=mode, **vi_settings())
        seconds, launched = [], []
        for _ in range(runs):
            before = count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples, new_state = opt_vi.update(start, state)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            launched.append({k: v - before[k] for k, v in count().items()})
        trees = [("position", samples.pos)] + [(f"sample {i}", s) for i, s in enumerate(samples)]
        for what, tree in trees:
            for k, v in tree.items():
                for leaf in torch.utils._pytree.tree_leaves(v):  # an ICR key: a leaf a level
                    if leaf.device != dev or not bool(torch.isfinite(leaf).all()):
                        fail(f"{phase} {mode}: {what} leaf {k} on {leaf.device} or non-finite")
        kl_before = float(opt_vi.kl_value_and_grad(start.pos, primals_samples=samples)[0])
        kl_after = float(new_state.minimization_state.fun)
        timed = seconds[1:] or seconds
        emit({"phase": phase, "mode": mode, "samples": len(samples),
              "s_per_iteration_median": float(np.median(timed)), "s_per_iteration_all": seconds,
              "launches_per_iteration": launched[-1], "kl_before": kl_before, "kl_after": kl_after,
              "kl_status": int(new_state.minimization_state.status),
              "sample_state": str(new_state.sample_state)[:200],
              "peak_mem_bytes": torch.cuda.max_memory_allocated(), "maps": maps, **extra})
        if not kl_after <= kl_before:
            fail(f"{phase} {mode}: the KL rose over the Newton step ({kl_before} -> {kl_after})")
        read_launches(phase, need, refuse, need if maps == "vmap" else ())
        if maps == "lmap" and any(batched[phase].values()):
            fail(f"{phase}: a batch of samples under lmap, a loop of one ({batched[phase]})")
        idle = [k for k in need if launched[-1][k] == 0]
        if idle:
            fail(f"{phase}: {idle} not launched in the last iteration ({launched[-1]})")
        return samples, launched[-1]

    def rel_tree(got, ref):
        num = sum(float(((got[k].double() - ref[k].double()) ** 2).sum()) for k in ref)
        return (num / sum(float((ref[k].double() ** 2).sum()) for k in ref)) ** 0.5

    def fewer_launches(phase, per_vmap, per_lmap, kernels):
        """One launch per batch: under vmap each kernel of ``kernels`` runs at
        most half as often an iteration as under lmap (batches of 2 and 4)."""
        for k in kernels:
            if not 0 < 2 * per_vmap[k] <= per_lmap[k]:
                fail(f"{phase}: {k} launched {per_vmap[k]} times an iteration under vmap, "
                     f"{per_lmap[k]} under lmap: a batch is not one launch")

    knot_only = dict(need=("K3", "K4"), refuse=("K1", "K2"))
    lh_vi, start_np = build_vi_likelihood(VI_SHAPE, dev, torch.float32, KNOTS)
    start = nt.Samples(pos=nt.position_from_numpy(lh_vi.forward_model, start_np))
    seed = int(np.random.default_rng(3).integers(2**62))
    opt_vi = nt.OptimizeVI(lh_vi, 1)  # the defaults: kl_map and residual_map "vmap"
    info = {"shape": [VI_SHAPE] * 2, "knots": KNOTS}
    mgvi, per_vmap = vi_phase("vi_mgvi_vmap", **knot_only, opt_vi=opt_vi, start=start,
                              mode="linear_resample", seed=seed, runs=4, maps="vmap", **info)
    vi_phase("vi_geovi_vmap", **knot_only, opt_vi=opt_vi, start=start,
             mode="nonlinear_resample", seed=seed, runs=4, maps="vmap", **info)
    opt_lmap = nt.OptimizeVI(lh_vi, 1, kl_map="lmap", residual_map="lmap")
    _, per_lmap = vi_phase("vi_mgvi_lmap", **knot_only, opt_vi=opt_lmap, start=start,
                           mode="linear_resample", seed=seed, runs=1, maps="lmap", **info)
    fewer_launches("vi", per_vmap, per_lmap, ("K3", "K4"))
    # the KL under both maps at the MGVI iteration's samples and position:
    # no solve, so f32 rounding only
    native.reset_launches()
    tan = nt.position_from_numpy(lh_vi.forward_model, {
        k: np.random.default_rng(4).standard_normal(v.shape) for k, v in start_np.items()})
    kl = {m: (_kl_vg(lh_vi, mgvi.pos, mgvi, map=m), _kl_met(lh_vi, mgvi.pos, tan, mgvi, map=m))
          for m in ("vmap", "lmap")}
    (vv, gv), mv = kl["vmap"]
    (vl, gl), ml = kl["lmap"]
    # the KL is a sum over pixels and samples of terms of both signs: f32
    # rounds it to the scale of the terms' magnitudes, not of the sum
    with torch.no_grad():
        scale = float(np.mean([
            float(lam.sum() + (lh_vi.likelihood.data * torch.log(lam)).abs().sum()
                  + 0.5 * sum((v.double() ** 2).sum() for v in smp.values()))
            for smp in mgvi for lam in [lh_vi.forward_model(smp)]]))
    errs = {"value": abs(float(vv) - float(vl)) / scale, "gradient": rel_tree(gv, gl),
            "metric": rel_tree(mv, ml)}
    # one KL step by trust-NCG (Steihaug CG 10): a step is taken only if it lowers the KL
    t0 = time.perf_counter()
    tr = opt_vi.kl_minimize(mgvi, minimize=nt.trust_ncg, minimize_kwargs=dict(
        maxiter=1, subproblem_kwargs=dict(maxiter=10, miniter=10)))
    torch.cuda.synchronize()
    emit({"phase": "vi_kl", "check": "kl_maps_and_trust_ncg", "rel_err_vmap_vs_lmap": errs,
          "trust_ncg_kl_before": float(vv), "trust_ncg_kl_after": float(tr.fun),
          "trust_ncg_status": int(tr.status), "trust_ncg_s": time.perf_counter() - t0})
    bad = {k: e for k, e in errs.items() if not e <= TOL["kl_maps"]}
    if bad:
        fail(f"vi: the KL under vmap and lmap differ: {bad} > {TOL['kl_maps']}")
    if not float(tr.fun) <= float(vv):
        fail(f"vi: trust_ncg raised the KL ({float(vv)} -> {float(tr.fun)})")
    read_launches("vi_kl", **knot_only, batch=knot_only["need"])
    del lh_vi, start, opt_vi, opt_lmap, mgvi, kl, gv, gl, mv, ml, tr
    torch.cuda.empty_cache()

    # -- 8. the exact-spectrum VI: MGVI at 1280², geoVI at 1024² ----------------
    exact = {}
    for mode, n in EXACT_VI.items():
        lh_x, start_np = build_vi_likelihood(n, dev, torch.float32, None)
        start = nt.Samples(pos=nt.position_from_numpy(lh_x.forward_model, start_np))
        info = {"shape": [n, n], "knots": None}
        name = "mgvi" if mode == "linear_resample" else "geovi"
        smpls, per_vmap = vi_phase(f"exact_{name}_vmap", FIELD, (), nt.OptimizeVI(lh_x, 1), start,
                                   mode, seed, 3, maps="vmap", **info)
        if mode == "linear_resample":
            _, per_lmap = vi_phase(
                f"exact_{name}_lmap", FIELD, (),
                nt.OptimizeVI(lh_x, 1, kl_map="lmap", residual_map="lmap"), start, mode, seed, 1,
                maps="lmap", **info)
            fewer_launches("exact_vi", per_vmap, per_lmap, FIELD)
            exact = {"likelihood": lh_x, "samples": smpls}
        del lh_x, start, smpls
        torch.cuda.empty_cache()

    # -- 9. the ELBO at the 1280² exact MGVI posterior ----------------------------
    lh_x, post = exact["likelihood"], exact["samples"]
    with tempfile.TemporaryDirectory() as tmp:  # the eigensystem, saved as users save it
        native.reset_launches()
        t0 = time.perf_counter()
        elbo_samples, stats = nt.estimate_evidence_lower_bound(
            lh_x, post, key=torch.Generator(device=dev).manual_seed(42), verbose=False,
            output_directory=tmp, **ELBO)
        torch.cuda.synchronize()
        elbo_s = time.perf_counter() - t0
        read_launches("elbo", FIELD)
        with np.load(os.path.join(tmp, "metric_eigsys.npz")) as f:
            evals, evecs = f["eigenvalues"], torch.from_numpy(f["eigenvectors"]).to(dev)
    met, _, _, _ = _ravel_metric(nt.StandardHamiltonian(lh_x).metric, post.pos)
    ritz = [float(torch.linalg.vector_norm(met(v) - float(lam) * v)) / float(lam)
            for lam, v in zip(evals, evecs)]
    emit({"phase": "elbo", "shape": [EXACT_VI["linear_resample"]] * 2, **ELBO,
          "n_found": int(evals.size), "eigenvalues": evals.tolist(),
          "ritz_residual_over_lambda": ritz, "stats": stats, "elbo_samples": elbo_samples.tolist(),
          "seconds": elbo_s})
    if evals.size == 0 or not float(evals.min()) >= 1.0 - TOL["eigenvalue"]:
        fail(f"elbo: eigenvalues {evals.tolist()} not all >= 1 - {TOL['eigenvalue']}")
    if not max(ritz) <= TOL["ritz"]:
        fail(f"elbo: Ritz residuals {ritz} above {TOL['ritz']} of their eigenvalues")
    if not all(np.isfinite(v) for v in stats.values()):
        fail(f"elbo: stats not finite: {stats}")
    del exact, lh_x, post, evecs

    # -- 10. NUTS and HMC on the 1280² exact posterior, 4 chains -----------------
    n = MCMC["shape"]
    lh_m, _ = build_vi_likelihood(n, dev, torch.float32, None)
    truth_np = latent_draw(lh_m.forward_model.domain, 0)  # the latent that made the counts
    chains = MCMC["chains"]
    start = nt.position_from_numpy(lh_m.forward_model, {
        k: np.repeat(v[None], chains, axis=0) for k, v in truth_np.items()}, batch=(chains,))
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, info = nt.nuts_sample(
        lh_m, MCMC["seed"], n_chains=chains, n_samples=MCMC["n_samples"],
        n_warmup=MCMC["n_warmup"], initial_position=start, max_tree_depth=MCMC["max_tree_depth"],
        step_size=MCMC["step_size"])
    torch.cuda.synchronize()
    nuts_s = time.perf_counter() - t0
    read_launches("mcmc_nuts", FIELD, batch=FIELD)
    for i, smp in enumerate(samples):
        for k, v in smp.items():
            if v.device != dev or not bool(torch.isfinite(v).all()):
                fail(f"mcmc: sample {i} leaf {k} on {v.device} or non-finite")
    n_trans = MCMC["n_warmup"] + MCMC["n_samples"]
    steps = info["leapfrog_steps"][0].tolist()  # the batch's, each step two batched gradients
    eps = info["step_size"].tolist()
    last = {k: v[:, -1] for k, v in info["chain_samples"].items()}
    potential = lambda q: -nt.LogDensity(lh_m)(q)  # noqa: E731
    proto = {k: v[0] for k, v in last.items()}
    ravel = Ravel(proto)
    grad, x_last = Potential(potential, ravel).gradient, ravel.ravel(last)
    grad_ms = float(np.median(event_ms(lambda: grad(x_last), 5)))
    # the batched gradient, each chain against plain autograd in f64 on the CPU
    cf64 = bench_field(n, "cpu", torch.float64, None)
    lh64 = nt.Poissonian(lh_m.likelihood.data.cpu(), device="cpu").amend(
        nt.ChainModel(torch.exp, cf64))
    g4 = ravel.unravel(grad(x_last))
    grad_err = []
    for c in range(chains):
        q64 = {k: v[c].double().cpu().requires_grad_(True) for k, v in last.items()}
        g64 = dict(zip(q64, torch.autograd.grad(-nt.LogDensity(lh64)(q64), list(q64.values()))))
        grad_err.append(rel_l2({k: v[c] for k, v in g4.items()}, g64))
    if not max(grad_err) <= TOL["gradient"]:
        fail(f"mcmc: batched gradient against CPU f64, relative L2 {grad_err} > {TOL['gradient']}")
    # one transition of each chain by lmap (a batch of one each) and by vmap,
    # the chains' seeds those nuts_sample drew from the same seed
    nuts_chain = nt.NUTSChain(potential, 1.0, proto, step_size=eps[0],
                              max_tree_depth=MCMC["max_tree_depth"])
    keys = nt.evi.seeds(torch.Generator().manual_seed(MCMC["seed"]), chains)
    by_map = {}
    for cmap in ("lmap", "vmap"):
        native.reset_launches()
        by_map[cmap], _ = nuts_chain.generate_n_samples(keys, last, 1, chain_map=cmap)
        torch.cuda.synchronize()
        read_launches(f"mcmc_nuts_{cmap}", FIELD, batch=FIELD if cmap == "vmap" else ())
    if any(batched["mcmc_nuts_lmap"].values()):
        fail(f"mcmc: a batch of chains under lmap ({batched['mcmc_nuts_lmap']})")
    maps_err = [rel_l2({k: v[c, 0] for k, v in by_map["lmap"].samples.items()},
                       {k: v[c, 0].double().cpu() for k, v in by_map["vmap"].samples.items()})
                for c in range(chains)]
    maps_depths = {m: ch.depths[:, 0].tolist() for m, ch in by_map.items()}
    if maps_depths["lmap"] != maps_depths["vmap"] or not max(maps_err) <= TOL["metric"]:
        fail(f"mcmc: lmap and vmap transitions differ: depths {maps_depths}, "
             f"relative L2 {maps_err} > {TOL['metric']}")
    # one HMC transition of each chain, 8 leapfrog steps at chain 0's adapted step
    hmc_chain = nt.HMCChain(potential, 1.0, proto, num_steps=MCMC["hmc_steps"], step_size=eps[0])
    native.reset_launches()
    t0 = time.perf_counter()
    hmc_out, _ = hmc_chain.generate_n_samples(keys, last, 1)
    torch.cuda.synchronize()
    hmc_s = time.perf_counter() - t0
    read_launches("mcmc_hmc", FIELD, batch=FIELD)
    if not all(bool(torch.isfinite(v).all()) for v in hmc_out.samples.values()):
        fail("mcmc: an HMC sample is non-finite")
    # ΔH of 8 leapfrog steps of the 4 chains in one batch, from their last
    # samples at their adapted steps, the card against float64 on the CPU
    p0 = {k: torch.from_numpy(v).to(dev, torch.float32) for k, v in latent_draw(last, 11).items()}
    dh32, q8, p8 = leapfrog_energy_change(lh_m, last, p0, eps, MCMC["hmc_steps"])
    dh32_f32_sums = [hamiltonian_f32_sums(lh_m, {k: v[c] for k, v in q8.items()},
                                          {k: v[c] for k, v in p8.items()})
                     - hamiltonian_f32_sums(lh_m, {k: v[c] for k, v in last.items()},
                                            {k: v[c] for k, v in p0.items()})
                     for c in range(chains)]
    to64 = lambda t: {k: v.double().cpu() for k, v in t.items()}  # noqa: E731
    dh64, _, _ = leapfrog_energy_change(lh64, to64(last), to64(p0), eps, MCMC["hmc_steps"])
    dh_err, dh_err_f32 = np.abs(dh32 - dh64), np.abs(np.array(dh32_f32_sums) - dh64)
    emit({"phase": "mcmc", "shape": [n, n], "variant": "exact", "dtype": "float32",
          "settings": {k: v for k, v in MCMC.items() if k != "shape"},
          "start": "the latent that drew the counts, all chains", "nuts_s": nuts_s,
          "s_per_transition_median_sampling": float(np.median(
              info["transition_seconds"][0, MCMC["n_warmup"]:].numpy())),
          "s_per_transition_all": info["transition_seconds"][0].tolist(),
          "tree_depths": info["tree_depths"].tolist(),
          "leapfrog_steps_per_transition_batch": steps,
          "gradient_evaluations_per_transition_batch": [2 * x for x in steps],
          "batched_gradient_ms_median": grad_ms,
          "launches_per_transition": {k: launches["mcmc_nuts"].get(NAMES[k], 0) / n_trans
                                      for k in FIELD},
          "step_size": eps, "acceptance": info["acceptance"].tolist(),
          "divergences": info["divergences"].tolist(),
          "warmup_divergences": info["warmup_divergences"].tolist(),
          "batched_gradient_rel_l2_vs_cpu_f64": grad_err,
          "lmap_vs_vmap_transition": {"depths": maps_depths, "rel_l2": maps_err},
          "hmc_s": hmc_s, "hmc_acceptance": hmc_out.acceptance.tolist(),
          "dH_card_f64_sums": dh32.tolist(), "dH_card_f32_sums": dh32_f32_sums,
          "dH_cpu_f64": dh64.tolist(), "dH_err": dh_err.tolist(),
          "dH_err_f32_sums": dh_err_f32.tolist(), "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if not dh_err.max() <= TOL["dH"]:
        fail(f"mcmc: ΔH over {MCMC['hmc_steps']} leapfrog steps {dh32} on the card, {dh64} in "
             f"f64 on the CPU: {dh_err} > {TOL['dH']}")
    nuts_ref = dict(lh=lh_m, start=start, info=info)  # 17e's "vmap" chains
    del lh_m, lh64, cf64, samples, info, last, start, nuts_chain, hmc_chain, hmc_out, by_map
    del grad, x_last, g4, q8, p8
    torch.cuda.empty_cache()

    # -- 10b. bench_extra.py's NUTS row: 64² knot16, one chain ------------------
    n = NUTS_ROW["shape"]
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((n, n), distances=1.0 / n, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=None, n_mode_knots=16)
    cf = cfm.finalize(device=dev, dtype=torch.float32)
    with torch.no_grad():
        truth = cf(nt.position_from_numpy(cf, latent_draw(cf.domain, 4))).double().cpu().numpy()
    data = (truth + 0.3 * np.random.default_rng(5).normal(size=(n, n))).astype(np.float32)
    ham = nt.StandardHamiltonian(
        nt.Gaussian(data, noise_std_inv=lambda x: (1 / 0.3) * x, device=dev).amend(cf))
    pos = nt.position_from_numpy(cf, latent_draw(cf.domain, 6))
    row = nt.NUTSChain(ham, 1.0, pos, step_size=0.05, max_tree_depth=8)
    native.reset_launches()
    _, (draws, pos) = row.generate_n_samples(7, pos, 1)  # warm-up, not timed
    drawn, depths = 0, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while drawn < NUTS_ROW["n_samples"] and time.perf_counter() - t0 < NUTS_ROW["budget_s"]:
        out, (draws, pos) = row.generate_n_samples(draws, pos, 1)
        drawn += 1
        depths.append(int(out.depths[0]))
    torch.cuda.synchronize()
    row_s = time.perf_counter() - t0
    read_launches("mcmc_nuts_64", (), refuse=NAMES)
    if not all(bool(torch.isfinite(v).all()) for v in pos.values()):
        fail("mcmc 64²: the chain's position is non-finite")
    emit({"phase": "mcmc_row", "shape": [n, n], "knots": 16, "dtype": "float32",
          "source": "bench_extra.py:267-300 (one NUTSChain, step 0.05, depth <= 8, sigma 0.3)",
          "samples": drawn, "of": NUTS_ROW["n_samples"], "seconds": row_s,
          "samples_per_s": drawn / row_s, "tree_depths": depths,
          "kernels": "none: 64 is below K3/K4's multiple of 256 and the knot form has no K1/K2"})
    del cf, ham, row, pos, draws

    # -- 11. the likelihoods' metrics at 1280² exact against CPU float64 -----------
    n = SHAPES_MAIN[0]
    cf32, cf64 = bench_field(n, dev, torch.float32, None), bench_field(n, "cpu", torch.float64, None)
    pos_np, tan_np = latent_draw(cf32.domain, 13), latent_draw(cf32.domain, 14)
    rng = np.random.default_rng(12)
    data = {"real": rng.standard_normal((n, n)), "bits": rng.integers(0, 2, (n, n)),
            "classes": rng.integers(0, 3, (n, n, 1)), "beta": rng.uniform(0.5, 2.0, (n, n)),
            "complex": rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))}

    def amend(lh, fwd, cf):
        return lh.amend(nt.ChainModel(fwd, cf))

    # name: (the likelihood of the field, from real data of dtype rd / complex data of dtype cd)
    cases = {
        "student_t": ("StudentT(dof 4, noise_std_inv 2) of the field", lambda cf, rd, cd, d: amend(
            nt.StudentT(data["real"].astype(rd), 4.0, noise_std_inv=2.0, device=d), lambda f: f, cf)),
        "bernoulli": ("Bernoulli of sigmoid(field)", lambda cf, rd, cd, d: amend(
            nt.Bernoulli(data["bits"], device=d), torch.sigmoid, cf)),
        "variable_covariance_gaussian": ("(field, exp(-field)) as (mean, std_inv)",
                                         lambda cf, rd, cd, d: amend(
            nt.VariableCovarianceGaussian(data["real"].astype(rd), device=d),
            lambda f: (f, torch.exp(-f)), cf)),
        "variable_covariance_student_t": ("(field, exp(-field)) as (mean, std), dof 4",
                                          lambda cf, rd, cd, d: amend(
            nt.VariableCovarianceStudentT(data["real"].astype(rd), 4.0, device=d),
            lambda f: (f, torch.exp(-f)), cf)),
        "categorical": ("logits (field, -field, field/2) along a last axis",
                        lambda cf, rd, cd, d: amend(
            nt.Categorical(data["classes"], device=d),
            lambda f: torch.stack([f, -f, 0.5 * f], dim=-1), cf)),
        "inverse_gamma": ("InverseGamma of exp(field), alpha -0.5", lambda cf, rd, cd, d: amend(
            nt.InverseGamma(data["beta"].astype(rd), device=d), torch.exp, cf)),
        "gaussian_complex": ("complex data, mean (1 + 0.5i) field", lambda cf, rd, cd, d: amend(
            nt.Gaussian(data["complex"].astype(cd), noise_cov_inv=2.0, device=d),
            lambda f: f * (1 + 0.5j), cf)),
        "sum": ("Gaussian(field) + Bernoulli(sigmoid(field))", lambda cf, rd, cd, d: amend(
            nt.Gaussian(data["real"].astype(rd), noise_cov_inv=4.0, device=d), lambda f: f, cf)
            + amend(nt.Bernoulli(data["bits"], device=d), torch.sigmoid, cf)),
    }
    native.reset_launches()
    lik = {}
    for name, (_, build) in cases.items():
        lh32 = build(cf32, np.float32, np.complex64, dev)
        lh64 = build(cf64, np.float64, np.complex128, "cpu")
        m32 = lh32.metric(nt.position_from_numpy(cf32, pos_np), nt.position_from_numpy(cf32, tan_np))
        m64 = lh64.metric(nt.position_from_numpy(cf64, pos_np), nt.position_from_numpy(cf64, tan_np))
        for k, v in m32.items():
            if v.device != dev or not bool(torch.isfinite(v).all()):
                fail(f"likelihoods: {name} metric leaf {k} on {v.device} or non-finite")
        lik[name] = err = rel_l2(m32, m64)
        if not err <= TOL["metric"]:
            fail(f"likelihoods: {name} metric at {n}²: relative L2 {err} > {TOL['metric']}")
    torch.cuda.synchronize()
    read_launches("likelihoods", FIELD)
    emit({"phase": "likelihoods", "shape": [n, n], "variant": "exact", "dtype": "float32",
          "models": {k: v[0] for k, v in cases.items()}, "rel_l2_vs_cpu_f64": lik})
    del cf32, cf64, data

    # -- 12. models: Matérn, density estimator, NDVCG, parametric VI, remat ------
    f32, f64 = torch.float32, torch.float64
    t12 = time.perf_counter()

    def finite(tree, what):
        for leaf in torch.utils._pytree.tree_leaves(tree):
            if leaf.device != dev or not bool(torch.isfinite(leaf).all()):
                fail(f"{what}: a leaf on {leaf.device} or non-finite")

    # 12a. the Matérn field at 1280², table and pixel forms; a VModel of 4 fields
    n = MODELS["matern"]
    tab32 = matern_field(n, dev, f32)
    counts = poisson_at_own_draw(nt.ChainModel(torch.exp, tab32))
    tab64 = nt.Poissonian(counts, device="cpu").amend(
        nt.ChainModel(torch.exp, matern_field(n, "cpu", f64)))
    pos_np, tan_np = latent_draw(tab32.domain, 13), latent_draw(tab32.domain, 14)
    native.reset_launches()
    p, _ = metric_phase("matern", "table", n, nt.Poissonian(counts, device=dev).amend(
        nt.ChainModel(torch.exp, tab32)), pos_np, tan_np, tab64)
    read_launches("matern_table", FIELD)
    pix32 = matern_field(n, dev, f32, pixel_expansion=True)
    native.reset_launches()
    metric_phase("matern", "pixel", n, nt.Poissonian(counts, device=dev).amend(
        nt.ChainModel(torch.exp, pix32)), pos_np, tan_np, tab64)
    read_launches("matern_pixel", ("K3", "K4"), refuse=("K1", "K2"))
    with torch.no_grad():
        forms_err = rel_max(pix32(p), tab32(p))
    if not forms_err <= TOL["forms"]:
        fail(f"matern: the pixel form's field {forms_err} off the table form's > {TOL['forms']}")
    del tab32, tab64, pix32, p
    cf4 = bench_field(n, dev, f32)
    vm = nt.VModel(cf4, MODELS["channels"])  # every key mapped: 4 spectra, 4 excitations
    counts4 = np.random.default_rng(MODELS["seed"]).poisson(1.0, (MODELS["channels"], n, n))
    lh_v = nt.Poissonian(counts4.astype(np.int32), device=dev).amend(nt.ChainModel(torch.exp, vm))
    p4 = nt.position_from_numpy(vm, latent_draw(vm.domain, 15))
    t4 = nt.position_from_numpy(vm, latent_draw(vm.domain, 16))
    native.reset_launches()
    m4 = lh_v.metric(p4, t4)
    torch.cuda.synchronize()
    read_launches("vmodel", FIELD, batch=FIELD)
    vm_ms = float(np.median(event_ms(lambda: lh_v.metric(p4, t4), 5)))
    separate = [nt.Poissonian(counts4[i].astype(np.int32), device=dev).amend(
        nt.ChainModel(torch.exp, cf4)).metric({k: v[i] for k, v in p4.items()},
                                              {k: v[i] for k, v in t4.items()})
                for i in range(MODELS["channels"])]
    vm_err = rel_tree(m4, {k: torch.stack([m[k] for m in separate]) for k in m4})
    emit({"phase": "matern", "shape": [n, n], "table_vs_pixel_field_rel_max": forms_err,
          "vmodel_channels": MODELS["channels"], "vmodel_metric_ms_median": vm_ms,
          "vmodel_vs_separate_rel_l2": vm_err})
    if not vm_err <= TOL["forms"]:
        fail(f"vmodel: the metric {vm_err} off 4 separate applies > {TOL['forms']}")
    del cf4, vm, lh_v, p4, t4, m4, separate
    torch.cuda.empty_cache()

    # 12b. the density estimator at 1280² (2560² padded): one MGVI iteration
    shape = MODELS["density"]
    dens, pshape = nt.density_estimator(shape, device=dev, dtype=f32)
    cut = tuple(slice(0, s) for s in shape)
    rate = nt.ChainModel(lambda f: f[cut], dens)
    lh_d = nt.Poissonian(density_counts(shape, MODELS["density_events"]), device=dev).amend(rate)
    start = nt.Samples(pos=nt.position_from_numpy(rate, latent_draw(rate.domain, 2)))
    vi_phase("density_mgvi_vmap", FIELD, (), nt.OptimizeVI(lh_d, 1), start, "linear_resample",
             seed, 2, maps="vmap", shape=list(shape), padded=list(pshape),
             n_unique=dens.correlated_field.indexes[0].n_unique, events=MODELS["density_events"])
    del dens, rate, lh_d, start
    torch.cuda.empty_cache()

    # 12c. NDVariableCovarianceGaussian at 1280², d = 2, covariance and precision
    n = MODELS["ndvcg"]
    fwd = ndvcg_forward(bench_field(n, dev, f32))
    fwd64 = ndvcg_forward(bench_field(n, "cpu", f64))
    with torch.no_grad():
        mean_t, mat_t = fwd64(nt.position_from_numpy(fwd64, latent_draw(fwd64.domain, 0)))
    eps = torch.from_numpy(np.random.default_rng(21).standard_normal((n, n, 2, 1)))
    pos_np, tan_np = latent_draw(fwd.domain, 17), latent_draw(fwd.domain, 18)
    ndvcg = {}
    for covariance in (True, False):
        name = "ndvcg_covariance" if covariance else "ndvcg_precision"
        cov = mat_t if covariance else torch.linalg.inv(mat_t)
        data = (mean_t + (torch.linalg.cholesky(cov) @ eps)[..., 0]).numpy()
        lh = nt.NDVariableCovarianceGaussian(data.astype(np.float32), covariance, device=dev).amend(fwd)
        lh64 = nt.NDVariableCovarianceGaussian(data, covariance, device="cpu").amend(fwd64)
        native.reset_launches()
        e32 = float(lh.energy(nt.position_from_numpy(fwd, pos_np)))
        p, _ = metric_phase("ndvcg", name, n, lh, pos_np, tan_np, lh64)
        read_launches(name, FIELD, batch=FIELD)
        e64 = float(lh64.energy(nt.position_from_numpy(fwd64, pos_np)))
        # a sum of 2 n² terms of order one and both signs: held at the scale of their count
        ndvcg[name] = err = abs(e32 - e64) / max(abs(e64), data.size)
        if not err <= TOL["metric"]:
            fail(f"{name}: energy {e32} on the card, {e64} in f64 on the CPU: {err} > {TOL['metric']}")
    with torch.no_grad():
        mat = fwd(p)[1].contiguous()
    dmat = torch.randn(mat.shape, generator=g, device=dev)
    dmat = dmat + dmat.mT
    eigh_ms = float(np.median(event_ms(lambda: _eigh(mat), 5)))
    jvp = lambda: torch.func.jvp(nt.sym_sqrtm, (mat,), (dmat,))  # noqa: E731
    pull = lambda: torch.func.vjp(nt.sym_sqrtm, mat)[1](dmat)[0]  # noqa: E731
    dk_ms = float(np.median(event_ms(jvp, 5)))
    pull_ms = float(np.median(event_ms(pull, 5)))
    y, dy = jvp()
    y64, dy64 = torch.func.jvp(nt.sym_sqrtm, (mat.double().cpu(),), (dmat.double().cpu(),))
    g64 = torch.func.vjp(nt.sym_sqrtm, mat.double().cpu())[1](dmat.double().cpu())[0]
    finite((y, dy), "sym_sqrtm on the card")
    dk_err = {"value": rel_max(y.double().cpu(), y64), "jvp": rel_max(dy.double().cpu(), dy64),
              "pull_back": rel_max(pull().double().cpu(), g64)}
    if not max(dk_err.values()) <= TOL["metric"]:
        fail(f"ndvcg: sym_sqrtm on the card against CPU f64 {dk_err} > {TOL['metric']}")
    interp = nt.invgamma_prior(3.0, 2.0).to(dev)
    x = torch.randn((n, n), generator=g, device=dev)
    interp_ms = float(np.median(event_ms(lambda: interp(x), 5)))
    iy = interp(x)
    finite(iy, "the interpolant on the card")
    interp_err = rel_max(iy.double().cpu(), nt.invgamma_prior(3.0, 2.0)(x.double().cpu()))
    if not interp_err <= TOL["interp"]:
        fail(f"interpolant: {interp_err} off CPU f64 > {TOL['interp']}")
    emit({"phase": "ndvcg", "shape": [n, n, 2], "energy_rel_err_vs_cpu_f64": ndvcg,
          "matrices": int(mat.numel() // 4), "eigh_chunk": EIGH_CHUNK, "eigh_ms_median": eigh_ms,
          "sym_sqrtm_jvp_ms_median": dk_ms, "sym_sqrtm_pull_back_ms_median": pull_ms,
          "sym_sqrtm_rel_max_vs_cpu_f64": dk_err, "interpolant": "invgamma_prior(3, 2)",
          "interpolant_ms_median": interp_ms, "interpolant_rel_max_vs_cpu_f64": interp_err})
    del fwd, fwd64, mean_t, mat_t, lh, lh64, p, mat, dmat, y, dy, interp, x, iy
    torch.cuda.empty_cache()

    # 12d. parametric VI: MeanFieldVI at 1280² exact, FullCovarianceVI at 32²
    lh_vi, pos_np, _ = build_likelihood(MODELS["vi"], dev, f32)
    mf = nt.MeanFieldVI(lh_vi, nt.position_from_numpy(lh_vi.forward_model, pos_np),
                        n_samples=MODELS["vi_samples"])
    losses = []
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mf.fit(MODELS["seed"], n_steps=MODELS["vi_steps"], callback=lambda i, q, v: losses.append(v))
    torch.cuda.synchronize()
    mf_s = time.perf_counter() - t0
    read_launches("vi_meanfield", FIELD, batch=FIELD)
    finite(mf.params, "MeanFieldVI's parameters")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        fail(f"MeanFieldVI: losses {losses} not finite or not falling")
    n = MODELS["fullcov"]
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((n, n), distances=1.0 / n, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), n_mode_knots=16)
    fwd = nt.ChainModel(torch.exp, cfm.finalize(device=dev, dtype=f32))
    lh_fc = nt.Poissonian(poisson_at_own_draw(fwd), device=dev).amend(fwd)
    fc = nt.FullCovarianceVI(lh_fc, nt.position_from_numpy(fwd, latent_draw(fwd.domain, 2)),
                             n_samples=MODELS["vi_samples"])
    fc_losses = []
    native.reset_launches()
    t0 = time.perf_counter()
    fc.fit(MODELS["seed"], n_steps=MODELS["fullcov_steps"],
           callback=lambda i, q, v: fc_losses.append(v))
    torch.cuda.synchronize()
    fc_s = time.perf_counter() - t0
    read_launches("vi_fullcov", (), refuse=NAMES)
    finite(fc.params, "FullCovarianceVI's parameters")
    if not np.all(np.isfinite(fc_losses)):
        fail(f"FullCovarianceVI: losses {fc_losses} not finite")
    emit({"phase": "parametric_vi", "meanfield": {
              "shape": [MODELS["vi"]] * 2, "dof": int(mf.params["mean"].numel()),
              "samples": MODELS["vi_samples"], "steps": MODELS["vi_steps"],
              "ms_per_step": 1e3 * mf_s / MODELS["vi_steps"], "losses": losses,
              "mean_first_5": first, "mean_last_5": last},
          "fullcov": {"shape": [n, n], "dof": int(fc.params["mean"].numel()),
                      "steps": MODELS["fullcov_steps"],
                      "ms_per_step": 1e3 * fc_s / MODELS["fullcov_steps"],
                      "loss_first": fc_losses[0], "loss_last": fc_losses[-1]},
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    del lh_vi, mf, fwd, lh_fc, fc
    torch.cuda.empty_cache()

    # 12e. one metric apply at 4096² exact, with and without RematModel
    n = MODELS["remat"]
    lh, pos_np, tan_np = build_likelihood(n, dev, f32)
    lh_r = nt.Poissonian(lh.likelihood.data).amend(
        nt.ChainModel(torch.exp, nt.RematModel(lh.forward_model.inner)))
    p = nt.position_from_numpy(lh.forward_model, pos_np)
    t = nt.position_from_numpy(lh.forward_model, tan_np)
    peaks, out = {}, {}
    native.reset_launches()
    for name, l in (("plain", lh), ("remat", lh_r), ("plain_again", lh)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[name] = l.metric(p, t)
        torch.cuda.synchronize()
        peaks[name] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                       "above_inputs_bytes": torch.cuda.max_memory_allocated() - base}
        if name != "plain_again":
            finite(out[name], f"remat: the {name} metric")
    read_launches("remat", FIELD)
    remat_err = rel_tree(out["remat"], out["plain"])
    emit({"phase": "remat", "shape": [n, n], "variant": "exact", "peak_memory": peaks,
          "rel_l2_remat_vs_plain": remat_err})
    if not remat_err <= TOL["remat"]:
        fail(f"remat: the metric {remat_err} off the plain model's > {TOL['remat']}")
    del lh, lh_r, p, t, out
    torch.cuda.empty_cache()
    emit({"phase": "models_total", "seconds": time.perf_counter() - t12})

    # -- 13. responses: tomography, sampled LOS, NUFFT, SKI, dynamics, operators --
    t13 = time.perf_counter()
    R = RESPONSES
    rng = np.random.default_rng(R["seed"])

    def rel64(got, ref):
        """Relative L2 of a card tensor against a float64 CPU one."""
        got = got.detach().cpu().to(ref.dtype)
        return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))

    # 13a. demo 1 at full width: 1280² exact field, exp, ExactGridLOS
    n, rays = R["shape"], R["rays"]
    lh_t, lh_t64, start_np, table_s = tomography(n, rays, dev)
    los = lh_t.forward_model.outer
    tab = los.table
    emit({"phase": "responses_tomography_tables", "shape": [n, n], "rays": rays,
          "table_seconds": table_s, "table_bytes": tab.table_bytes(),
          "ray_width": int(tab.idx.shape[1]), "cells_hit": int(tab.cols.numel()),
          "cell_width": int(tab.t_rows.shape[1]),
          "mean_cells_a_ray": float((tab.wgt > 0).sum(1).double().mean())})
    tan_np = latent_draw(lh_t.forward_model.domain, 3)
    native.reset_launches()
    p, t = metric_phase("responses_tomography", "exact_los", n, lh_t, start_np, tan_np, lh_t64)
    with torch.no_grad():
        rho = lh_t.forward_model.inner(p)
    cot = torch.randn((rays,), generator=g, device=dev)
    _, pull_los = torch.func.vjp(los, rho)
    _, pull_model = torch.func.vjp(lh_t.forward_model, p)
    same_los = bool(torch.equal(pull_los(cot)[0], pull_los(cot)[0]))
    # the whole model's, leaf by leaf (printed, no gate): the correlated field's own
    # pull-back is not bit-reproducible on the card (PERF.md §7)
    m1, m2 = pull_model(cot)[0], pull_model(cot)[0]
    model_diff = {k: float((m1[k] - m2[k]).abs().max()) for k in m1}
    torch.cuda.synchronize()
    read_launches("responses_tomography", FIELD)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with nt.extra.no_host_transfers("log"):
            lh_t.metric(p, t)
    torch.cuda.synchronize()
    syncs = [str(w.message)[:160] for w in caught if "called a synchronizing" in str(w.message)]
    los_ms = {"forward": float(np.median(event_ms(lambda: los(rho), 5))),
              "pull_back": float(np.median(event_ms(lambda: pull_los(cot), 5)))}
    emit({"phase": "responses_tomography", "los_pull_back_bit_identical": same_los,
          "model_pull_back_max_abs_diff_by_leaf": model_diff, "los_ms_median": los_ms,
          "metric_syncs": len(syncs), "metric_sync_messages": sorted(set(syncs))})
    if not same_los:
        fail("tomography: two pull-backs of one cotangent through the LOS differ")
    vi_phase("responses_tomography_mgvi_vmap", FIELD, (), nt.OptimizeVI(lh_t, 1),
             nt.Samples(pos=nt.position_from_numpy(lh_t.forward_model, start_np)),
             "linear_resample", seed, 2, maps="vmap", shape=[n, n], rays=rays)
    del lh_t64, p, t, pull_los, pull_model, m1, m2
    torch.cuda.empty_cache()

    # 13b. the sampled LOS on 1024 of 13a's rays against the exact one
    starts, ends = tomography_rays(rays)
    m = R["sampled_rays"]
    kw = dict(shape=(n, n), distances=1.0 / n, device=dev, dtype=f32)
    sampled = nt.SamplingCartesianGridLOS(starts[:m], ends[:m], n_sampling_points=R["sampled_points"],
                                          **kw)
    exact_sub = nt.ExactGridLOS(starts[:m], ends[:m], **kw)
    native.reset_launches()
    a, b = sampled(rho), exact_sub(rho)
    _, pull = torch.func.vjp(sampled, rho)
    g_s = pull(cot[:m])[0]
    finite((a, g_s), "sampled LOS")
    sampled_ms = {"forward": float(np.median(event_ms(lambda: sampled(rho), 5))),
                  "pull_back": float(np.median(event_ms(lambda: pull(cot[:m]), 5)))}
    torch.cuda.synchronize()
    read_launches("responses_sampled", (), refuse=NAMES)
    excess = float(((a - b).abs() - TOL["sampled_los"] * (1 + b.abs())).max())
    emit({"phase": "responses_sampled", "rays": m, "points_a_ray": R["sampled_points"],
          "rel_max_vs_exact": rel_max(a, b), "excess_over_tolerance": excess, "ms_median": sampled_ms})
    if not excess <= 0:
        fail(f"sampled LOS: {excess} beyond {TOL['sampled_los']} (abs and rel) of the exact LOS")
    tomo_ref = dict(lh=lh_t, start_np=start_np, tan_np=tan_np)  # 17c reuses the model and tables
    del lh_t, los, tab, rho, sampled, exact_sub, pull, a, b, g_s
    torch.cuda.empty_cache()

    # 13c. NUFFT: a 1024² complex image at 2^20 points
    n, npts = R["nufft_shape"], R["nufft_points"]
    img = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    coords = rng.uniform(-0.5, 0.5, (2, npts)).astype(np.float32)
    x = torch.from_numpy(img).to(dev, torch.complex64)
    c = torch.from_numpy(coords).to(dev)
    native.reset_launches()
    y = nt.nufft2(x, c)
    k = R["nufft_checked"]
    jj = np.arange(n) - n // 2
    e0 = np.exp(-2j * np.pi * coords[0, :k, None].astype(np.float64) * jj)
    e1 = np.exp(-2j * np.pi * coords[1, :k, None].astype(np.float64) * jj)
    # the direct DFT at the card's (rounded) image and coordinates, separable: y_k = e0_k X e1_k
    direct = np.einsum("ki,ik->k", e0, img.astype(np.complex64).astype(np.complex128) @ e1.T)
    dft_err = float(np.abs(y[:k].cpu().numpy() - direct).max() / np.abs(direct).max())
    yv = torch.from_numpy(rng.standard_normal(npts) + 1j * rng.standard_normal(npts)).to(
        dev, torch.complex64)
    adj = nt.nufft_adjoint(yv, c, (n, n))
    lhs = complex(torch.vdot(yv.to(torch.complex128), y.to(torch.complex128)))
    rhs = complex(torch.vdot(adj.reshape(-1).to(torch.complex128), x.reshape(-1).to(torch.complex128)))
    adj_err = abs(lhs - rhs) / abs(lhs)
    vp = nt.ops.nufft.VariablePositionNufft((n, n), npts)
    grid = rng.standard_normal((n, n))
    q = {"nufftcoord": c, "nufftgrid": torch.from_numpy(grid).to(dev, f32)}
    q64 = {"nufftcoord": torch.from_numpy(coords.astype(np.float64)), "nufftgrid": torch.from_numpy(grid)}

    def loss(z):
        return (vp(z).abs() ** 2).sum() / npts

    gc = torch.func.grad(loss)(q)["nufftcoord"]
    finite(gc, "the NUFFT's gradient in coords")
    grad_err = rel_max(gc.double().cpu(), torch.func.grad(loss)(q64)["nufftcoord"])
    nufft_ms = {"nufft2": float(np.median(event_ms(lambda: nt.nufft2(x, c), 5))),
                "nufft_adjoint": float(np.median(event_ms(lambda: nt.nufft_adjoint(yv, c, (n, n)), 5)))}
    torch.cuda.synchronize()
    read_launches("responses_nufft", (), refuse=NAMES)
    emit({"phase": "responses_nufft", "shape": [n, n], "points": npts, "oversampled": [2 * n, 2 * n],
          "kernel_width": 6, "checked_points": k, "max_err_vs_direct_dft_over_max": dft_err,
          "adjoint_rel_err": adj_err, "coords_grad_rel_max_vs_cpu_f64": grad_err,
          "ms_median": nufft_ms})
    if not (dft_err <= TOL["nufft_dft"] and adj_err <= TOL["adjoint"] and grad_err <= TOL["nufft_grad"]):
        fail(f"nufft: against the direct DFT {dft_err} (> {TOL['nufft_dft']}?), adjointness "
             f"{adj_err} (> {TOL['adjoint']}?), coords gradient {grad_err} (> {TOL['nufft_grad']}?)")
    del x, c, y, yv, adj, vp, q, q64, gc
    torch.cuda.empty_cache()

    # 13d. SKI: HarmonicSKI on 1024² inducing points padded to 1536², ToeplitzSKI 1-D
    n, npts = R["ski_grid"], R["ski_points"]
    pts = rng.uniform(0.02, 0.98, (2, npts))
    ski64 = nt.HarmonicSKI((n, n), [(0.0, 1.0)] * 2, pts, harmonic_kernel=lambda k: 1.0 / (
        1.0 + (k / 5.0) ** 2) ** 2, padding=R["ski_padding"], device="cpu", dtype=f64)
    ski = copy.deepcopy(ski64).to(dev, f32)
    xs = rng.standard_normal((2, npts))
    x32, y32 = (torch.from_numpy(v).to(dev, f32) for v in xs)
    native.reset_launches()
    cx = ski(x32)
    ski_err = rel64(cx, ski64(torch.from_numpy(xs[0])))
    cy = ski(y32)
    sym = abs(float(torch.vdot(y32.double(), cx.double()) - torch.vdot(cy.double(), x32.double())))
    sym_err = sym / float(torch.linalg.vector_norm(y32.double()) * torch.linalg.vector_norm(cx.double()))
    ski_ms = float(np.median(event_ms(lambda: ski(x32), 5)))
    torch.cuda.synchronize()
    read_launches("responses_ski", ("K3", "K4"), refuse=("K1", "K2"))
    tn, ntp = R["toeplitz_grid"], R["toeplitz_points"]
    tpts = rng.uniform(0.01, 0.99, (1, ntp))
    tk = lambda r: torch.exp(-0.5 * (r / 0.01) ** 2)  # noqa: E731
    toe64 = nt.ToeplitzSKI((tn,), [(0.0, 1.0)], tpts, kernel=tk, device="cpu", dtype=f64)
    toe = copy.deepcopy(toe64).to(dev, f32)
    tx = rng.standard_normal(ntp)
    tx32 = torch.from_numpy(tx).to(dev, f32)
    toe_err = rel64(toe(tx32), toe64(torch.from_numpy(tx)))
    toe_ms = float(np.median(event_ms(lambda: toe(tx32), 5)))
    emit({"phase": "responses_ski", "grid": [n, n], "padded": list(ski.grid_shape), "points": npts,
          "rel_l2_vs_cpu_f64": ski_err, "symmetry_err": sym_err, "ms_median": ski_ms,
          "toeplitz": {"grid": tn, "points": ntp, "rel_l2_vs_cpu_f64": toe_err, "ms_median": toe_ms}})
    if not (ski_err <= TOL["ski"] and sym_err <= TOL["symmetry"] and toe_err <= TOL["ski"]):
        fail(f"ski: harmonic {ski_err}, symmetry {sym_err}, Toeplitz {toe_err} beyond "
             f"{TOL['ski']} / {TOL['symmetry']}")
    del ski64, ski, x32, y32, cx, cy, toe64, toe, tx32
    torch.cuda.empty_cache()

    # 13e. the light-cone dynamics at (512, 1024); regrid, convolution, interpolation at 1280²
    shape = R["dynamics"]
    dyn, _ = nt.dynamic_lightcone_operator(
        shape=shape, distances=(1.0 / shape[0], 1.0 / shape[1]), key="dyn", lightcone_key="speed",
        sm_s0=1.0, sm_x0=(8.0, 8.0), sigc=0.3, quant=2.0, harmonic_padding=R["dynamics_padding"])
    # the reference evaluates at the card's (float32-rounded) inputs: the transfer
    # field is 1/m, and near the zeros of the Gaussian m the rounding of these
    # latents alone moves it by ~7e-5 (relative L2), ~600 times f32's epsilon
    rounded = lambda d: {k: v.astype(np.float32).astype(np.float64) for k, v in d.items()}  # noqa: E731
    lat, tan = rounded(latent_draw(dyn.domain, 4)), rounded(latent_draw(dyn.domain, 5))
    ct = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64).astype(
        np.complex128)
    on = lambda d, where, dt: {k: torch.from_numpy(v).to(where, dt) for k, v in d.items()}  # noqa: E731
    lat32 = on(lat, dev, f32)
    native.reset_launches()
    val, jt = torch.func.jvp(dyn, (lat32,), (on(tan, dev, f32),))
    vj = torch.func.vjp(dyn, lat32)[1](torch.from_numpy(ct).to(dev, torch.complex64))[0]
    val64, jt64 = torch.func.jvp(dyn, (on(lat, "cpu", f64),), (on(tan, "cpu", f64),))
    vj64 = torch.func.vjp(dyn, on(lat, "cpu", f64))[1](torch.from_numpy(ct))[0]
    # the lightspeed latent's cotangent is one sum over the grid of terms of
    # both signs: held at the scale of the terms' magnitudes, as phase 7's KL
    unit = {"dyn": torch.zeros(dyn.domain["dyn"].shape, dtype=f64), "speed": torch.ones(1, dtype=f64)}
    dspeed = torch.func.jvp(dyn, (on(lat, "cpu", f64),), (unit,))[1]
    speed_scale = float((torch.conj(dspeed) * torch.from_numpy(ct)).real.abs().sum())
    dyn_err = {"value": rel64(val, val64), "jvp": rel64(jt, jt64), "vjp_dyn": rel64(vj["dyn"], vj64["dyn"]),
               "vjp_speed_over_its_terms": float((vj["speed"].double().cpu() - vj64["speed"]).abs().max())
               / speed_scale}
    dyn_ms = float(np.median(event_ms(lambda: dyn(lat32), 5)))
    n = R["operators"]
    field = rng.standard_normal((n, n))
    f32_card, f64_cpu = torch.from_numpy(field).to(dev, f32), torch.from_numpy(field)
    ops = {"regrid": nt.operators.regrid((R["regrid"], R["regrid"])),
           "func_convolution": nt.operators.func_convolution(
               (n, n), 1.0 / n, lambda r: np.exp(-0.5 * (r / 0.005) ** 2)),
           "linear_interpolation": nt.operators.linear_interpolation(
               rng.uniform(0.0, 1.0, (2, R["interp_points"])), distances=1.0 / n)}
    op_err = {k: rel_max(op(f32_card).double().cpu(), op(f64_cpu)) for k, op in ops.items()}
    op_ms = {k: float(np.median(event_ms(lambda op=op: op(f32_card), 5))) for k, op in ops.items()}
    torch.cuda.synchronize()
    read_launches("responses_dynamics_operators", (), refuse=NAMES)
    emit({"phase": "responses_dynamics_operators", "dynamics": {
              "shape": list(shape), "padding": list(R["dynamics_padding"]), "rel_vs_cpu_f64": dyn_err,
              "ms_median": dyn_ms},
          "operators": {"shape": [n, n], "regrid_to": [R["regrid"]] * 2,
                        "interp_points": R["interp_points"], "rel_max_vs_cpu_f64": op_err,
                        "ms_median": op_ms}})
    bad = {k: e for k, e in dyn_err.items() if not e <= TOL["metric"]}
    bad.update({k: e for k, e in op_err.items() if not e <= TOL["operators"]})
    if bad:
        fail(f"dynamics/operators against CPU f64: {bad}")
    del dyn, lat32, val, jt, vj, f32_card, ops
    torch.cuda.empty_cache()
    emit({"phase": "responses_total", "seconds": time.perf_counter() - t13})

    # -- 14. the sphere: K5/K6, the synthesis, the spherical field at nside 256 --
    from nifty_tpu_torch.ops import cuda_legendre as cl
    from nifty_tpu_torch.ops import sht

    t14 = time.perf_counter()
    S = SPHERE

    def legendre_work(plan, B):
        """Bytes, f32 and f64 operations of one K5 or K6 call: every (l, m,
        ring) triple a recurrence step (two multiplies and an FMA: 4 f64
        operations, the peak counting an FMA as 2) and 2 B multiply-adds
        into the hemispheres' even and odd sums."""
        M = plan.mmax + 1
        triples = plan.n_half * sum(plan.lmax - m + 1 for m in range(M))
        n_bytes = (4 * B * plan.size + 8 * B * plan.n_rings * M  # alm, ring coefficients
                   + 16 * M * (plan.lmax + 1) + 8 * M * plan.n_half + 8 * plan.n_half)  # tables
        return n_bytes, 4.0 * B * triples, 4.0 * triples

    # 14a. K5/K6 against their plain versions (float64 on the card): the square
    # plans (lmax = mmax = 2 nside) at B = 1, 2, 4 (and 8, 16: the tensor cores), and
    # the plans and batches that 14d (lmax 3/2 nside, B = 1) and 14e (the regular
    # axis in the batch) give them, and a batch that ends in a partial group of 4
    n_sph, n_reg = S["product"]
    cases = {(nside, 2 * nside): [(B, "14a") for B in (1, 2, 4)] for nside in S["kernel_nsides"]}
    for nside in S["tensor_core_nsides"]:
        cases[(nside, 2 * nside)].extend([(8, "14a"), (16, "14a")])
    cases.setdefault((n_sph, 2 * n_sph), []).extend([(n_reg, "14e"), (6, "partial group")])
    cases.setdefault((S["analysis"], 3 * S["analysis"] // 2), []).append((1, "14d"))
    for (nside, lmax), batches in cases.items():
        plan = cl.LegendrePlan(sht.healpix_ring_geometry(nside)[0], lmax, lmax)
        plan_d = copy.deepcopy(plan).to(dev)
        table = legendre_table(plan_d) if nside <= S["table_max_nside"] else None
        for B, shape_of in batches:
            alm = torch.randn((B, plan.size), generator=g, device=dev)
            out = cl.legendre_contract(alm, plan_d)
            ref = cl.legendre_contract_plain(alm.double(), plan_d)
            e5 = rel_max(out.double(), ref)
            cot = torch.randn((B, plan.n_rings, plan.mmax + 1, 2), generator=g, device=dev)
            back = cl.legendre_contract_t(cot, plan_d)
            same = torch.equal(back, cl.legendre_contract_t(cot, plan_d))
            ref6 = cl.legendre_contract_t_plain(cot.double(), plan_d)
            e6 = rel_max(back.double(), ref6)
            n_bytes, f32_ops, f64_ops = legendre_work(plan, B)
            plain_iters = dict(iters=1, warmup=1)  # a loop over l: thousands of launches a call
            lib5 = lib6 = None
            if table is not None:  # contraction only, the table precomputed
                c, G, _, _ = legendre_bmm_operands(plan_d, alm, cot)
                lib5 = device_ms(lambda: torch.bmm(table, c))
                lib6 = device_ms(lambda: torch.bmm(table.transpose(1, 2), G))
                del c, G
            k5 = timing(device_ms(lambda: cl.legendre_contract(alm, plan_d)),
                        device_ms(lambda: cl.legendre_contract_plain(alm, plan_d), **plain_iters),
                        n_bytes, f32_ops, library_ms=lib5, flops64=f64_ops)
            k6 = timing(device_ms(lambda: cl.legendre_contract_t(cot, plan_d)),
                        device_ms(lambda: cl.legendre_contract_t_plain(cot, plan_d), **plain_iters),
                        n_bytes, f32_ops, library_ms=lib6, flops64=f64_ops)
            line = {"phase": "kernels", "kernel": "K5+K6", "nside": nside, "lmax": plan.lmax,
                    "B": B, "shape_of": shape_of, "alm": plan.size, "rings": plan.n_rings,
                    "tensor_cores": cl.launch_config(plan, B).mma,
                    "library": None if table is None else
                    "torch.bmm against a float32 λ table: contraction only, table precomputed",
                    "k5_rel_err": e5, "k6_rel_err": e6, "k6_same_bits": same,
                    **{f"k5_{k}": v for k, v in k5.items()}, **{f"k6_{k}": v for k, v in k6.items()}}
            if B == 1 and shape_of == "14a":  # by m band: the seed underflows float32 at large m
                bands = np.array_split(np.arange(plan.mmax + 1), 4)
                line["k5_rel_err_by_m_band"] = {
                    f"{b[0]}-{b[-1]}": rel_max(out[..., b[0]:b[-1] + 1, :].double(),
                                               ref[..., b[0]:b[-1] + 1, :]) for b in bands}
            emit(line)
            if not (e5 <= TOL["legendre"] and e6 <= TOL["legendre"] and same):
                fail(f"K5/K6 at nside {nside} lmax {lmax} B={B}: {e5}, {e6} (> {TOL['legendre']}?), "
                     f"K6 the same bits twice: {same}")
            keep = nside == S["field"] and B == 1  # the field's plan
            record("K5", float((out.double() - ref).abs().max()), k5 if keep else None)
            record("K6", float((back.double() - ref6).abs().max()), k6 if keep else None)
            del alm, out, ref, cot, back, ref6
        del plan, plan_d, table
        torch.cuda.empty_cache()

    # 14b. the synthesis: device and wall ms; against float64 on the CPU
    rng14 = np.random.default_rng(14)
    for nside in S["kernel_nsides"]:
        t0 = time.perf_counter()
        synth64 = sht.HealpixSynthesis(nside)  # float64 tables on the host
        build_s = time.perf_counter() - t0
        synth = copy.deepcopy(synth64).to(dev, f32)
        x = rng14.standard_normal(synth.size).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        y = synth(xd)
        finite(y, f"synthesis at nside {nside}")
        line = {"phase": "sphere_synthesis", "nside": nside, "lmax": synth.lmax,
                "pixels": synth.npix, "alm": synth.size, "tables_s": build_s,
                "device_ms": device_ms(lambda: synth(xd)),
                "ms_median": float(np.median(event_ms(lambda: synth(xd), 10)))}
        if nside in S["checked"]:
            line["rel_max_vs_cpu_f64"] = err = rel_max(y.double().cpu(),
                                                       synth64(torch.from_numpy(x).double()))
            if not err <= TOL["synthesis"]:
                fail(f"synthesis at nside {nside}: {err} > {TOL['synthesis']} against CPU f64")
        emit(line)
        del synth64, synth, xd, y
        torch.cuda.empty_cache()

    # 14c. the spherical field at nside 256: a metric apply and one MGVI iteration
    n = S["field"]
    t0 = time.perf_counter()
    sky32, sky64 = sphere_field(n, dev, f32), sphere_field(n, "cpu", f64)
    lh_s, lh_s64 = gaussian_at_own_draw(sky32, sky64, S["noise"], dev)
    build_s = time.perf_counter() - t0
    pos_np, tan_np = latent_draw(sky32.domain, 51), latent_draw(sky32.domain, 52)
    p, t = (nt.position_from_numpy(sky32, v) for v in (pos_np, tan_np))
    native.reset_launches()
    m = lh_s.metric(p, t)
    torch.cuda.synchronize()
    read_launches("sphere_metric", SPHERE_KERNELS, refuse=("K3", "K4"))
    finite(m, "the spherical metric")
    times = event_ms(lambda: lh_s.metric(p, t), 10)
    err = rel_l2(m, lh_s64.metric(*(nt.position_from_numpy(sky64, v) for v in (pos_np, tan_np))))
    emit({"phase": "sphere_metric", "nside": n, "pixels": 12 * n * n,
          "alm": int(sky32.domain["skyxi"].shape[0]), "models_s": build_s,
          "metric_apply_ms_median": float(np.median(times)), "metric_apply_ms_all": times,
          "rel_l2_vs_cpu_f64": err, "launches": launches["sphere_metric"]})
    if not err <= TOL["metric"]:
        fail(f"the spherical metric at nside {n}: relative L2 {err} > {TOL['metric']}")
    start = nt.Samples(pos=nt.position_from_numpy(sky32, latent_draw(sky32.domain, 2)))
    vi_phase("sphere_mgvi_vmap", SPHERE_KERNELS, ("K3", "K4"), nt.OptimizeVI(lh_s, 1), start,
             "linear_resample", seed, 2, maps="vmap", nside=n, pixels=12 * n * n)
    del sky32, sky64, lh_s, lh_s64, p, t, m, start
    torch.cuda.empty_cache()

    # 14d. the analysis' round trip on a band-limited map
    na = S["analysis"]
    la = 3 * na // 2
    alm = torch.from_numpy(rng14.standard_normal(cl.alm_size(la, la))).to(dev, f32)
    native.reset_launches()
    t0 = time.perf_counter()
    back = sht.healpix_analysis(sht.healpix_synthesis(alm, na, la), na, la)
    torch.cuda.synchronize()
    ana_s = time.perf_counter() - t0
    read_launches("sphere_analysis", ("K5", "K6"), refuse=FIELD)
    ana_err = float(torch.linalg.vector_norm(back - alm) / torch.linalg.vector_norm(alm))
    emit({"phase": "sphere_analysis", "nside": na, "lmax": la, "seconds": ana_s,
          "rel_l2_alm": ana_err})
    if not ana_err <= TOL["analysis"]:
        fail(f"analysis at nside {na}: the alm back within {ana_err} > {TOL['analysis']}")

    # 14e. a sphere times a regular axis: the metric against float64 on the CPU
    prod32 = sphere_field(n_sph, dev, f32, regular=n_reg)
    prod64 = sphere_field(n_sph, "cpu", f64, regular=n_reg)
    lh_p, lh_p64 = gaussian_at_own_draw(prod32, prod64, S["noise"], dev)
    pos_np, tan_np = latent_draw(prod32.domain, 53), latent_draw(prod32.domain, 54)
    p, t = (nt.position_from_numpy(prod32, v) for v in (pos_np, tan_np))
    native.reset_launches()
    m = lh_p.metric(p, t)
    torch.cuda.synchronize()
    read_launches("sphere_product", SPHERE_KERNELS)
    times = event_ms(lambda: lh_p.metric(p, t), 5)
    err = rel_l2(m, lh_p64.metric(*(nt.position_from_numpy(prod64, v) for v in (pos_np, tan_np))))
    emit({"phase": "sphere_product", "nside": n_sph, "regular": n_reg,
          "shape": [12 * n_sph**2, n_reg], "metric_apply_ms_median": float(np.median(times)),
          "rel_l2_vs_cpu_f64": err})
    if not err <= TOL["metric"]:
        fail(f"the sphere x regular metric: relative L2 {err} > {TOL['metric']}")
    del prod32, prod64, lh_p, lh_p64, p, t, m
    torch.cuda.empty_cache()
    emit({"phase": "sphere_total", "seconds": time.perf_counter() - t14})

    # -- 15. the multi-grid ICR fields (no kernel of this port runs here) --------
    from nifty_tpu_torch import multi_grid as mg

    t15 = time.perf_counter()

    def within_limit(build, depth):
        """``build(depth)`` (a float64 CPU model), the depth lowered one step
        at a time while a build takes more than ICR["build_limit_s"]."""
        while True:
            t0 = time.perf_counter()
            model = build(depth)
            secs = time.perf_counter() - t0
            if secs <= ICR["build_limit_s"] or depth <= 1:
                return model, depth, secs
            emit({"phase": "icr_build", "depth": depth, "seconds": secs, "lowered": True})
            depth -= 1

    def icr_check(name, f32m, f64m, info, seed_):
        """Forward ms and the forward and the Gaussian metric against float64
        on the CPU; no kernel of the port may launch."""
        lh, lh64 = gaussian_at_own_draw(f32m, f64m, ICR["noise"], dev)
        pos_np, tan_np = latent_draw(f32m.domain, seed_), latent_draw(f32m.domain, seed_ + 1)
        p, t = (nt.position_from_numpy(f32m, v) for v in (pos_np, tan_np))
        native.reset_launches()
        fwd = f32m(p)
        m = lh.metric(p, t)
        torch.cuda.synchronize()
        finite(fwd, f"icr {name}: the forward")
        finite(m, f"icr {name}: the metric")
        fwd_ms = float(np.median(event_ms(lambda: f32m(p), 10)))
        met_ms = float(np.median(event_ms(lambda: lh.metric(p, t), 10)))
        read_launches(f"icr_{name}", (), refuse=NAMES)
        with torch.no_grad():
            fwd_err = rel_max(fwd.double().cpu(), f64m(nt.position_from_numpy(f64m, pos_np)))
        met_err = rel_l2(m, lh64.metric(*(nt.position_from_numpy(f64m, v) for v in (pos_np, tan_np))))
        emit({"phase": "icr", "field": name, **info, "fine_shape": list(fwd.shape),
              "forward_ms_median": fwd_ms, "metric_apply_ms_median": met_ms,
              "forward_rel_max_vs_cpu_f64": fwd_err, "metric_rel_l2_vs_cpu_f64": met_err})
        if not (fwd_err <= TOL["metric"] and met_err <= TOL["metric"]):
            fail(f"icr {name}: forward {fwd_err}, metric {met_err} against CPU f64 > {TOL['metric']}")
        return lh

    # 15a-b. bench_extra.py:305's field and demo 4's learned Matérn field, MGVI of the first
    fields = icr_fields(dev, ICR["depth"])
    for name, (f32m, f64m, build_s) in fields.items():
        lh = icr_check(name, f32m, f64m, {"grid": "SimpleOpenGrid((16, 16), padding 1)",
                                           "depth": ICR["depth"], "build_s": build_s}, 61)
        if name == "fixed":
            start = nt.Samples(pos=nt.position_from_numpy(f32m, latent_draw(f32m.domain, 2)))
            vi_phase("icr_mgvi_vmap", (), TRANSFORMS, nt.OptimizeVI(lh, 1), start, "linear_resample",
                     seed, 2, maps="vmap", fine_shape=list(f32m.grid.shapes[-1]))
        del lh
    del fields
    torch.cuda.empty_cache()

    # 15c. HEALPix charted refinement
    nside0, depth = ICR["healpix"]
    hp64, depth, build_s = within_limit(lambda d: mg.HEALPixICRField(
        mg.HEALPixRefinementGrid(nside0=nside0, depth=d), lambda r: torch.exp(-r / 0.2),
        device="cpu", dtype=f64), depth)
    icr_check("healpix", copy.deepcopy(hp64).to(dev, f32), hp64,
              {"nside0": nside0, "depth": depth, "nside": nside0 << depth, "build_s": build_s}, 63)
    del hp64

    # 15d. sphere x log-radius
    nside0, n_r0, depth = ICR["sphere_radius"]
    sr64, depth, build_s = within_limit(lambda d: mg.SphereRadiusICRField(
        mg.SphereLogRadiusGrid(nside0=nside0, n_r0=n_r0, r_min=1.0, r_max=100.0, depth=d),
        lambda r: torch.exp(-r / 20.0), device="cpu", dtype=f64), depth)
    icr_check("sphere_radius", copy.deepcopy(sr64).to(dev, f32), sr64,
              {"nside0": nside0, "n_r0": n_r0, "depth": depth, "build_s": build_s}, 65)
    del sr64
    torch.cuda.empty_cache()
    emit({"phase": "icr_total", "seconds": time.perf_counter() - t15})

    # -- 16. the diagnostics and the output (AUX) ----------------------------------
    aux_phase(dev, read_launches, rel_l2)

    # -- 17. the multi-GPU slice (PARALLEL) ------------------------------------------
    summary.update(parallel_phase(dev, read_launches, timing, built=card, tomo=tomo_ref,
                                  nuts=nuts_ref))

    sources = {"K1": ("nifty_tpu_torch/csrc/expand.cu", "nifty_tpu/ops/pallas_expand.py:108"),
               "K2": ("nifty_tpu_torch/csrc/expand.cu", "nifty_tpu/ops/pallas_expand.py:161"),
               "K3": ("nifty_tpu_torch/csrc/hartley.cu", "nifty_tpu/ops/pallas_fft.py:169"),
               "K4": ("nifty_tpu_torch/csrc/hartley.cu", "nifty_tpu/ops/pallas_fft.py:246"),
               "K5": ("nifty_tpu_torch/csrc/legendre.cu",
                      "nifty_tpu/ops/sht.py:338 nifty_legendre_contract (XLA primitive, not Pallas)"),
               "K6": ("nifty_tpu_torch/csrc/legendre.cu",
                      "nifty_tpu/ops/sht.py:338 nifty_legendre_contract (XLA primitive, not Pallas)"),
               "K1r": ("nifty_tpu_torch/csrc/expand.cu", "nifty_tpu/ops/pallas_expand.py:108"),
               "K2r": ("nifty_tpu_torch/csrc/expand.cu", "nifty_tpu/ops/pallas_expand.py:161"),
               "K4r": ("nifty_tpu_torch/csrc/hartley.cu", "nifty_tpu/ops/pallas_fft.py:246"),
               "K7": ("nifty_tpu_torch/csrc/normal.cu",
                      "nifty_tpu/evi.py:90 random_like (XLA's shard-local threefry draw, not Pallas)")}
    kernels = [
        {"name": f"{k} {NAMES[k]}", "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1],
         "launches": sum(c.get(NAMES[k], 0) for c in launches.values()),
         "launches_by_phase": {ph: c.get(NAMES[k], 0) for ph, c in launches.items()},
         "batched_launches_by_phase": {ph: c.get(NAMES[k], 0) for ph, c in batched.items()},
         **summary[k]}
        for k in NAMES
    ]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
