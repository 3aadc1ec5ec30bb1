"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Fifteen groups of
paths are driven: the flagship forward ``rt_run`` (band kernel K1), the
rotational-Raman forward ``rt_run_inelastic`` (K1 for the elastic half, the
block-bichromatic RRS kernel K3 for the inelastic one), the aerosol
Jacobian run ``rt_run_lin`` (the multitangent kernel K2), the thermal
(K = 2, solar + Planck) Jacobian run ``rt_run_lin`` (K1', the same kernel
at two source columns), the multisensor
forward ``rt_run_ms`` (the per-layer doubling kernel K5, one launch per
moment for all layers), the flagship chain of per-layer steps of
``scripts/probe_fused2.py`` (the layer-step kernel K4) and the nine Pallas
probes P1-P9 of ``scripts/`` through their Hopper counterparts
(``vsmartmom_tpu_torch/probes``: the dot_chain, lane_dot_chain, layout and
band-stage kernels); and the gas path: the line-by-line absorption build
of the O2 A-band scene on the card (plain torch, float64) and its
``rt_run`` (K1) and VMR Jacobian ``rt_run_lin`` (K2 at P = 2); and the
Raman paths: vibrational Raman ``rt_run_inelastic(mode="VS_0to1")`` and
the stellar vibrational ``rt_run_stellar(mode="sol_VS_0to1")`` (plain
fixed-source solves on the card), the stellar rotational
``rt_run_stellar(mode="sol_RRS")`` (K1 and K3, the ie ladder at full
resolution) and the multisensor Raman ``rt_run_ms_rrs`` (plain torch);
and a GEOS-Chem column from its (synthetic) GCHP collections through the
TOML front end and ``model_from_parameters`` to ``rt_run`` (K1); and the
land and single-scatter paths: a vegetated red-edge column (a canopy over
an RPV soil, built on the card) through ``rt_run_full`` (K1) and
``rt_run_ss``, the standalone exact single scatter ``run_exact_ss`` and
the flagship on Gauss-Radau streams (K1); the five other entry points
over a spectrally resolved canopy surface (K2, K5, K1 + K3); the
spectral sharding over ``torch.distributed`` ranks (K1, K1 + K3); and the
wide-stream scenes (N 65-128) through K1's and K2's cluster kernels.
Phases, each of which fails the run (non-zero exit) on a miss:

1. setup — the card's name and power limit; every CUDA kernel of the port
   built from ``vsmartmom_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. kernel vs plain — each kernel's wrapper against its plain PyTorch version
   on the card at its main path's shapes, gate max|d| / max|ref| <= 1e-4 on
   every output: K1 at the flagship's (N = 52, nz = 33, ndoubl = 8, the
   probed Newton-Schulz schedule, nSpec = 1024, moments m = 0..2) and a
   small K = 2 (thermal source) case; K3 (its diagonal and pair launches)
   at the RRS+SIF scene's (N = 36, nz = 8, 58 Raman shifts x nSpec 256 =
   14,848 pairs, the coarse ie ladder, m = 0..2) and a small I-only case
   (N = 6) whose shifts run off the band edge for most pairs, which must
   come out exactly zero, against the dense plain version and the split
   one (``moment_rrs_split_reference``, the launches' own algebra), and
   within ``F64_RATIO`` of the f32 plain version's distance from the plain
   version in f64; its launch shapes (threads, shared memory, pool,
   resident blocks an SM of each launch); K2 at
   the aerosol flagship's (N = 52, nz = 33, C = 2, ndoubl = 11, the probed
   schedule, all P = 8 tangents, a 64-point slice, m = 0, 1, 15): primal
   <= 1e-4 of max|ref| per output, each parameter's tangent outputs
   <= 2e-4 of that parameter's max|ref| over the three moments; the
   kernel's and the f32 plain version's primal against the plain version
   in f64 on the same operands are printed beside it (no gate for K2;
   K1's composite from f64 must be within ``F64_RATIO`` = 2x of the f32
   plain version's, at every flagship moment and the K = 2 case); K1's
   launch shape as the C side reports it (threads, dynamic shared memory,
   blocks an SM by shared memory);
3. main paths, each with every launch counter set to 0 just before and read
   just after:
   * ``rt_run`` of the flagship (nSpec = 4096, f32, 4 chunks of 1024): R and
     T finite; the kernel path against the port's plain path on the first
     chunk (<= 1e-4 of max|R|); launches = chunks x (m_scat + 1); the
     flagship at nSpec = 16 against the stored JAX CPU f64 reference
     (``vsmartmom_tpu_torch/data/flagship_ref_f64.npz``, <= 1e-4);
   * ``rt_run_inelastic`` of the RRS+SIF scene (nSpec = 256): K1 and K3
     (a call, and its diagonal launch) once per moment; R, T, ieR, ieT
     finite; the kernel path
     against the port's plain ``rt_solve_rrs``, R <= 1e-4 and ieR <= 5e-3
     of max (the JAX bench's gate: the coarse ie ladder is by design), the
     total R + ieR <= 1e-4 of max|R|, and with ``ie_fullres=True``
     ieR <= 1e-4; a small RRS scene against the
     stored JAX CPU f64 reference (``data/rrs_ref_f64.npz``), R and ieR
     <= 1e-4 with ``ie_fullres=True``;
   * ``rt_run_lin`` of the aerosol flagship (nSpec = 1024, f32, 7 aerosol
     parameters + wind): K2 launched m_scat + 1 = 16 times (one per moment
     for all 8 tangents), K1 and K3 not at all; R, T, dR, dT finite, dR
     (9, 4, 1024, 8); on a 64-point slice the K2 route against the plain
     jvp route at moments 0..``ROUTE_CHECK_M`` (2), R <= 1e-4 and each
     parameter's dR <= 2e-4 of its max;
     ``rt_run`` of the same scene (16 K1 launches) equal to rt_run_lin's R
     within 1e-4; the small aerosol scene against the stored JAX CPU f64
     reference (``data/lin_ref_f64.npz``), R <= 1e-4 and each parameter's
     dR <= 2e-4 of its own max, the aerosol height's (p0, sigma_p)
     <= ``HEIGHT_GATE`` = 5e-3, with a control: those two Jacobians
     scaled by 1.01 must exceed it;
4. timing — the flagship's and the RRS+SIF solve's points/s (best of 3
   after a warm-up, synced with ``torch.cuda.synchronize``), and per kernel
   launch its time, its plain version's time and its bound:
   max(FLOPs / FP32 peak, bytes / HBM rate), K3's at the least work that
   gives its outputs (``rrs_flops``: off-grid pairs need none), for the
   call and for each of its two launches, with the former one-launch
   kernel's block count and the
   dense one printed beside it, the store's bytes and the diagonal
   launch's store against its plain version (``diagonal_store``); the
   Jacobian solve's points/s and tangent
   points/s (the solve inside the counted ``rt_run_lin``, tangents
   prebuilt by it and K2 loaded by the checks before it), the host
   seconds of the scene and tangent builds, and K2's time against its bound
   at the least work (the primal once, two products per tangent product),
   with the kernel's own count beside it: groups + 2P primal moments a
   point, the primal once per cluster of up to 4 tangents (P = 8: two
   groups of 4, 18 against the least 17); K2's launch plan (cluster size,
   groups, shared memory, resident clusters from
   ``cudaOccupancyMaxActiveClusters``, ptxas registers and spills of each
   K instance, which must agree with ``fused_lin.mt_plan``) and the cluster
   barriers a block passes per launch;

5. multisensor (``ms_phase``) — K5 against ``doubling_reference`` on the
   flagship's stash of one moment (33 layers x nSpec 1024 points): moment 0
   (every layer scatters: the dense ladder) <= 1e-4 per output and within
   2x of the f32 plain version's distance from the plain version in f64;
   moment 15 (Z = 0 above m_scat: the O(N) path) bit for bit with r
   exactly zero; ``rt_run_ms`` of the flagship (nSpec 1024, levels 0, 16, 33)
   and of the MS bench scene (``rrs_sif_model`` at nSpec 256, levels 0, 4,
   8; scripts/bench_ms.py), each counted: K5 launched m_max + 1 times and
   no other kernel, each launch's blocks that vote for the O(N) path
   counted on its operands and its device time read (a launch whose every
   block does must run in under a quarter of the fastest dense one); per
   level the kernel route against the plain (LU) route
   <= 1e-4 of max, and level 0 against the band path's rt_solve R and T
   <= 1e-4; ``ms_pts_per_s`` (best of 2 after a warm-up, synchronised), a
   device-time split of one more solve (CUDA events around the stash, K5,
   the interactions and the interface solves), and K5's time per launch
   against its plain version and its bound at moment 0 (operations) and at
   moment 15 (bytes: the O(N) path), each on its own line and in K5's
   kernels entry (``z0``) with the launches of its path in the counted
   run, and K5's resident blocks per SM from the C side;
6. layer chain (``layer_chain_phase``) — the flagship's elemental operators
   of moments 0..m_scat at nSpec 1024 chained through K4 over all 33
   layers from the vacuum composite, counted (3 x 33 launches), against the
   plain chain <= 1e-4 per output and against K1's composite of the same
   moment <= 1e-4 of max per output; the chain's time beside K1's for the
   same moments, and K4's time per launch against its plain version and
   its bound, and its resident blocks an SM. K4 runs K5's ladder and K1's
   adding on ``csrc/fp32_tile.cuh``: its chain's matrices must equal the
   plain chain's bit for bit, its sources (four partial sums a row) be
   within ``F64_RATIO`` of the f32 plain chain's distance from the plain
   chain in f64;
7. probes (``probes_phase``) — each probe module's ``run()`` at its
   script's own shapes with every launch counter set to 0 just before and
   read just after (it must equal the wrapper calls the cases report: one
   warm-up, ``probes.common.REPS`` timed calls per try and the checks),
   one JSON line per call site with each case's device time (the timed
   calls queued behind a sleeping kernel, ``probes.common.time_ms``),
   bound, plain and library times, its error against the plain version and
   against the f64 product; one line per dot and lane case with its launch
   plan (grid, threads, dynamic shared memory, resident blocks per SM from
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, slabs or points in
   flight per SM) and its kernel's ptxas registers and spills; one line per
   band-stage case with each of its launches (grid, threads, shared bytes,
   its entry's registers and spills) and its scratch. Gates: every
   kernel time the device's work alone; each host plan the launch the C
   side makes of it; dot and lane chains against their plain versions <= 1e-5 of
   max|plain| at lengths 1, 8 and the whole chain (a TF32 chain at length
   1 only: its drift is recorded), each chain's last step <= 1e-5 and
   equal bit for bit to the kernel's own chain; the layout cases exact;
   the band stages NaN where the plain version is NaN and <= 1e-5 of
   max|plain| where it is finite, the full stage finite throughout at one
   layer and on the thin inputs over four (the chain of adding steps), and
   one chain launch after each full call;
8. thermal Jacobian (``thermal_lin_phase``) on ``thermal_lin_model`` (the
   aerosol flagship at 2500 cm^-1 with each layer's Planck source; N = 52,
   nz = 33, C = 2, K = 2, P = 8) — K1' against its plain version on a
   64-point slice at m = 0, 1 and m_max (primal <= 1e-4, each parameter's
   tangents <= 2e-4 of its max; the thermal column of J0_p and J0_m
   non-zero at m = 0 and exactly zero, tangents too, above it; the primal
   against the f64 plain version printed, as for K2); the K = 2
   shared memory inside the 232,448 B opt-in; ``rt_run_lin`` at nSpec 1024
   counted (K2 launched m_scat + 1 times at K = 2, no other kernel), R, T,
   dR, dT finite, dR (9, 4, 1024, 8); on the slice, at moments
   0..``ROUTE_CHECK_M`` (2), the kernel route
   against the jvp route (R <= 1e-4, each dR <= 2e-4 of its max) and the
   additivity of the sources (dR and R of solar + thermal against the sum
   of the solar-only and the thermal-only runs, ``include_solar=False``,
   2e-4 and 1e-4); ``rt_run`` of the scene (K1 at K = 2) against R
   (1e-4); the small thermal scene against the stored JAX CPU f64
   reference (``data/lin_thermal_ref_f64.npz``, the K = 1 phase's gates
   with its 1.01 control); timing: the solve inside the counted
   ``rt_run_lin`` at nSpec 1024 (K1' loaded by the checks before it),
   K1''s time per launch,
   its plain version's and its bound at the least work (the K2 count with
   the second source column), its plan and barrier count as K2's;
9. absorption (``absorption_phase``) on ``flagship.aband_model`` (the
   flagship's column, ocean and IQUV from 12980 cm^-1, O2 from the
   synthetic A-band line list ``flagship.write_aband_par``; N = 52, 33
   layers) — the scene built on the card, the device line sum of all 33
   layers x 4096 points timed alone (``absorption_build_s``, best of 3),
   tau_abs's max and the share of points with column tau_abs > 1; the line
   sum on the card against the CPU's for the top, middle and bottom
   layers (f64, <= 1e-10 of max); K1 against its plain version on the
   A-band operands of the 1024-point chunk holding the strongest lines
   (m = 0..m_scat, <= 1e-4 per output, within ``F64_RATIO`` of the f32
   plain version's distance from f64); ``rt_run`` at nSpec 4096 counted
   (K1 4 x (m_scat + 1) times, no other kernel), R and T finite, the
   kernel path against the plain path on every chunk (<= 1e-4), the small
   A-band scene (``flagship.aband_ref_model``) against the stored JAX CPU
   f64 reference (``data/aband_ref_f64.npz``, <= 1e-4); the gas Jacobian
   ``rt_run_lin`` at nSpec 1024 (layout vmr_O2, wind_speed: P = 2) counted
   (K2 m_scat + 1 times, no other kernel), dR (9, 4, 1024, 2), K2's plan
   at P = 2, the kernel route against the jvp route on the 64 points
   around the strongest line (R <= 1e-4, each dR <= 2e-4 of its max),
   rt_run's R against it (1e-4), the small scene's R and each dR against
   the stored reference (1e-4, 2e-4); timing: ``aband_pts_per_s`` (best
   of 3 after a warm-up), ``aband_lin_pts_per_s`` (best of 2), the scene
   and line-sum seconds, and K2's time a launch at P = 2 against its bound
   at the least work (1 + 2P primal moments), its plain version's beside
   it (not in the kernels line, which keeps the flagship shapes);
10. Raman (``raman_phase``), every run with every launch counter set to 0
   just before and read just after — (a) ``rt_run_inelastic`` in VS_0to1
   on ``flagship.vs_sif_model`` (the RRS+SIF column, N = 36, on
   ``vs_band_grid(25000.0)``: 1335 points, 15 targets with weight): no
   kernel launched, every output finite, ieR exactly 0 at the incident
   point and > 0 at every weighted target, the small VS scene in both
   modes against ``data/vs_ref_f64.npz`` (<= 1e-4); (b) ``rt_run_stellar``
   in sol_RRS on ``flagship.stellar_sif_model`` (the column from 18000
   cm^-1 at 1.5625 cm^-1, 1024 points, 8 H2 shifts, a 70% line in
   ``f0_spec``): K3's plan at the full ie ladder (ndoubl, pool, shared
   memory), K1 and K3 (a call and its diagonal launch) once per moment
   and nothing else, outputs finite, the kernel path against the plain
   ``rt_solve_rrs`` on the card (R and ieR <= 1e-4), the Ring fill-in at
   the line (ieR/R at its core above its median), the small stellar
   scene against ``data/stellar_ref_f64.npz`` (R and ieR <= 1e-4); (c)
   ``rt_run_stellar`` in sol_VS_0to1 on ``flagship.stellar_vs_sif_model``
   (``sol_vs_plus_grid(540.0, dnu=1.0)``, 3552 points): no kernel, finite,
   ie light on the band, the small scenes of both VS modes against the
   stored reference (<= 1e-4); (d) ``rt_run_ms_rrs`` of the MS bench
   scene (RRS+SIF, nSpec 256, levels 0, 4, 8, 58 shifts) with the bytes
   of its per-layer ie stash printed first: no kernel, finite, level 0
   against the plain ``rt_solve_rrs`` on the card (<= 1e-4), the small
   scene in RRS and VS_0to1 against ``data/ms_rrs_ref_f64.npz`` (<=
   1e-4); timing: ``vs_pts_per_s``, ``stellar_rrs_pts_per_s``,
   ``stellar_vs_pts_per_s`` and ``ms_rrs_pts_per_s`` (each solve alone,
   after a warm-up, synchronised: the stellar RRS best of 3, the three
   launch-bound plain solves best of 2) and K3's time a call at the
   stellar shape against its least-work bound (``rrs_flops``), with its
   plain version's (not in the kernels line, which keeps the RRS+SIF
   shapes);
11. GEOS-Chem (``geoschem_phase``) on ``flagship.geoschem_model`` (the
   synthetic StateMet and Aerosols collections of
   ``flagship.write_geoschem_column`` in GCHP's C order, written to a
   temporary directory; the TOML scene with the column's profile,
   ``parameters_from_dict`` with ``validate=False``, as this machine has
   no jsonschema; three two-moment Mie aerosols by ``to_rt_aerosols`` at
   the column's mid-pressures; 72 layers, C = 4, N = 52, nSpec 4096) —
   the build timed (``geoschem_build_s``: file reads, ``to_rt_aerosols``,
   the Mie builds and ``build_band``, synchronised); the aerosol profiles
   read from the GCHP-ordered files equal to those read from their
   ``(lev, time)`` twins, exactly, for both scenes; ``rt_run`` counted (K1
   4 x (m_scat + 1) times, nothing else: no moment took the plain route),
   R and T finite; the kernel path against the plain path on the first
   chunk (<= 1e-4) and K1 against its plain version at m = 0 and m_scat
   (<= 1e-4); the small GEOS-Chem scene (``flagship.geoschem_ref_model``,
   6 levels, f32) through K1 against ``data/geoschem_ref_f64.npz``
   (<= 1e-4); timing: ``geoschem_pts_per_s`` (best of 2 after a warm-up)
   and K1's time a launch at 72 layers against its bound and its plain
   version's (not in the kernels line, which keeps the flagship shapes);
12. surfaces (``surfaces_phase``) — (a) ``flagship.canopy_model`` (the
   flagship's column, IQUV, N = 52, over 755 -> 672 nm at nSpec 4096; a
   canopy of LAI 3 in 3 sublayers with SYNTHETIC red-edge leaf optics, 7
   leaf-optics nodes, over an RPV soil; the synthetic solar spectrum and
   the default SIF) built on the card, timed (``canopy_build_s``: the
   slab in f64 on the card, the operators interpolated on the host, a
   (16, 4096, 52, 52) surface kept there and moved a chunk at a time);
   ``rt_run_full`` counted (K1 4 x (m_scat + 1) times, nothing else: the
   moments above m_scat on the Beer-law tail), R, T and hdr finite, the
   kernel path against the plain path (every moment down the full path)
   on the first chunk and K1 against its plain version (<= 1e-4), the
   small canopy scene (``canopy_ref_model``, f32) through K1 against
   ``data/surfaces_ref_f64.npz`` (<= 1e-4), and the scene at LAI 1e-6
   against the bare RPV soil (<= 1e-4); (b) ``rt_run_ss`` of the canopy
   column: no kernel, finite, its Stokes I at or below the full solve's
   (within 1e-4 of max), the small single-scatter scenes against the
   stored reference (<= 1e-4); (c) ``run_exact_ss`` at the flagship's
   geometry (33 Rayleigh layers and an HG aerosol, nSpec 4096): "all"
   paths over Lambertian and paths_1_2 over Cox-Munk finite, no kernel,
   the small configs and their Jacobians against the stored reference
   (1e-4; 2e-4 of each parameter's max); (d) the flagship at IQU on
   Gauss-Radau streams (``radau_model``, nSpec 1024, 17 nodes, N = 51,
   the solar node weighted): K1 against its plain version at every moment
   up to m_scat, ``rt_run`` counted, the kernel path against the plain
   path, the small Radau scene against the stored reference (<= 1e-4);
   timing: ``canopy_pts_per_s``, ``ss_pts_per_s`` and
   ``exact_ss_pts_per_s`` (each solve alone, best of 3 after a warm-up,
   synchronised), ``canopy_build_s`` with its surface stage (the stage
   table of ``utils.timing``), the move of the four chunks' 4-D surface
   to the card, and K1's time a launch on the canopy scene against its
   bound and its plain version's;
13. 4-D entries (``entries_4d_phase``) — each of the five other entry
   points on its own chip scene and width with ``flagship.over_canopy``
   in place of its surface (the canopy of ``canopy_surface`` over its RPV
   soil, its SYNTHETIC red edge moved to the band's middle, so the
   (16, nSpec, N, N) surface varies across the band; the phase fails a
   surface that does not): ``rt_run_lin`` of the aerosol flagship (nSpec
   1024, P = 7) counted (K2 m_scat + 1 times, nothing else), each of
   those launches on the 64 points from the brightest surface point
   against K2's plain version on those points' operands (moments
   0..``ROUTE_CHECK_M``:
   primal <= 1e-4, each tangent <= 2e-4 of its parameter's max), its
   kernel route against the jvp route on those points, moments 0..2 (R
   <= 1e-4, each dR <= 2e-4 of its max, the aerosol height's
   ``HEIGHT_GATE``, whose control, the kernel's height dR 1% off, must
   fail it) and each route's dR against an f64 run of the jvp route (the
   kernel's distance within ``F64_RATIO`` of the f32 plain route's, or
   2e-4); ``rt_run_ms`` of the flagship (nSpec 1024,
   levels 0, 16, 33) counted (K5 m_max + 1 times), the kernel route
   against the LU route per level (1e-4); ``rt_run_inelastic`` RRS of the
   RRS+SIF scene (nSpec 256) counted (K1, K3), the kernel route at the
   full ie ladder against the plain solve (R, T, ieR, ieT 1e-4; the
   coarse ie ladder's ieR 5e-3); ``rt_run_stellar`` sol_RRS (nSpec
   1024, K1 + K3) counted, the kernel route against the plain solve
   (1e-4); ``rt_run_ms_rrs`` of the MS bench scene counted (plain, no
   kernel), level 0 against the plain RRS solve (1e-4); the Jacobian
   and Raman routes compared on moments 0..``ROUTE_CHECK_M`` (2) of the
   canopy's 16. Each prints its launches, pts/s (the build included) and its
   surface's bytes on the host (f64) and on the card (the solve's dtype);
14. sharding (``sharding_phase``) — ``flagship.dryrun_multichip(1)``: one
   NCCL rank on the card; two gloo ranks sharing the card, spawned once
   (``parallel.run_ranks``, the kernels built before they start) on the
   flagship at nSpec 4096 through K1 (each rank 2048 points, m_scat + 1
   launches) and on the RRS+SIF scene at nSpec 1024 through K1 + K3 with
   each rank's halo (``parallel.shard_raman``, max|shift| points a side),
   the outputs gathered on the host, each against the unsharded run on
   the card (<= 1e-4; the distance and bit-equality printed);
15. wide (``wide_phase``) — launch checks on the flagship's column and
   ocean cut to 3 layers and 64 points (``flagship.wide_check_model``):
   K1 at N = 52, 64, 65, 68, 84, 104, 128 (K = 1) and 84, 128 (K = 2),
   every moment up to m_scat, each within 1e-4 of its plain version and
   within ``F64_RATIO`` of the f32 plain version's distance from f64, its
   plan (single block or cluster, band rows, threads, shared bytes,
   resident blocks or clusters) the host's; K2 at N = 52, 53, 84, 128 and
   K1' at 84, P = 8, moments 0 and 1 (primal 1e-4, each parameter's
   tangents 2e-4 of its max, the primal's f64 witness); each launch at N
   = 84 and 128 timed against its plain version and its bound (K2's at
   the least work, 1 + 2P primal moments, beside its own 3P), with its
   cluster size (printed); then three scenes, each counted with no width
   warning allowed: the IQUV Radau flagship (``radau_model``, N = 68,
   nSpec 1024, ``rt_run_full``: K1's single block), the flagship at nstreams
   16 (N = 84, nSpec 4096 in 4 chunks: K1's clusters, 4 (m_scat + 1)
   launches) and its aerosol Jacobian (N = 84, P = 8, nSpec 128: K2's
   wide plan, m_scat + 1 launches), each kernel route against the plain
   route on a slice (64 points; the Jacobian's 8) at moments
   0..``ROUTE_CHECK_M`` (1e-4; dR 2e-4 of each parameter's max, the
   aerosol height's ``HEIGHT_GATE`` with its 1.01 control), with its
   pts/s; the Jacobian's K2 launches at m = m_scat / 2 and m_scat
   against plain K2 on those 8 points (1e-4; tangents 2e-4, the aerosol
   height's by the f64 witness, ``tangent_f64_errors``). The
   kernels line times K1 on moment 0 of the wide flagship's first chunk
   and K2 on moment 0 of the Jacobian's own operands, each against its
   plain version on the same inputs, with its bound at that shape.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel. Without CUDA it exits non-zero and prints no result.
"""

import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense): FP32 outside the tensor cores,
#: and HBM3 bandwidth. The bound of a kernel is stated against these.
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
GATE = 1e-4
#: A kernel's distance from the plain version run in f64 on the same
#: operands may be at most this many times the f32 plain version's (K1 and
#: K5's dense ladder sum their products in another order than the plain
#: version's matmuls).
F64_RATIO = 2.0
IE_GATE = 5e-3
TAN_GATE = 2e-4
#: The aerosol-height parameters of the small Jacobian scene: their f32 dR
#: is ~1e-6 of the others' and lands within ~1.3e-3 of its own scale of
#: the f64 reference on every route; HEIGHT_GATE still fails a 1% error.
HEIGHT_PARAMS = ("_p0", "_sigma_p")
HEIGHT_GATE = 5e-3
N_CHUNK, N_CHUNKS = 1024, 4
N_SPEC_TOTAL = N_CHUNK * N_CHUNKS
RRS_N_SPEC = 256
LIN_N_SPEC, LIN_SLICE = 1024, 64
#: The thermal Jacobian scene's width and its checked slice.
THERMAL_N_SPEC, THERMAL_SLICE = 1024, 64
#: Shared memory one block may opt in to on an H100 (bytes).
SMEM_OPT_IN = 232448
#: The O2 A-band scene's width, its gas Jacobian scene's and the latter's
#: checked slice (``flagship.aband_model``).
ABAND_N_SPEC, ABAND_LIN_N_SPEC, ABAND_SLICE = 4096, 1024, 64
#: Multisensor scenes: the flagship at nSpec 1024 with an airborne sensor
#: mid-column, and the JAX package's MS bench scene (scripts/bench_ms.py).
MS_N_SPEC, MS_LEVELS = 1024, (0, 16, 33)
MS_RRS_N_SPEC, MS_RRS_LEVELS = 256, (0, 4, 8)
#: The GEOS-Chem column scene's width (``flagship.geoschem_model``).
GEOSCHEM_N_SPEC = 4096
#: The vegetated red-edge column's width (``flagship.canopy_model``) and the
#: Gauss-Radau flagship's (``flagship.radau_model``, IQU).
CANOPY_N_SPEC, RADAU_N_SPEC = 4096, 1024


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_time_ms(fn, reps=5):
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def moment_flops(config, n_spec):
    """FP32 operations of one fused_moment launch: the band kernel's matrix
    products for this run's Newton-Schulz schedule (the bench.py count at
    one spectral point per operator), 2 N^2 per product column."""
    N, K = config.N, config.n_sources
    cols = 0
    for k in config.ns_sched or (6,) * config.ndoubl:
        cols += (2 * k + 5) * N + 4 * K          # NS, r r, t gp, X, Y
    k = config.ns_inter
    cols += (2 * k + 3) * N + (N + K) + 2 * (2 * N + K) + (2 * N + K) + N
    return 2.0 * N * N * cols * config.nz * n_spec


def rrs_flops(ops, n_points, n_pairs, ns_sched, ns_inter, count="least"):
    """FP32 operations (an FMA is two) of one fused_moment_rrs call over
    P = nR x n_points (shift, point) pairs, n_pairs of them on the grid:
    the matrix and vector products of the ladder and the adding (the
    moment_flops count) on the (2N, 2N) block-lower-triangular pair
    operators, counted four ways:

    * "least", the bound's and the kernels': the least work giving the
      same outputs. Only the (2,1) block is a pair's own, 2 N^3 FMAs per
      product and 2 N^2 per product column, and an off-grid pair's is
      exactly zero (no work). The diagonal blocks are elastic ladders and
      composites of one grid point (l1 = i, l0 = i + shift), needed once
      per point: N^3 and N^2 per point;
    * "pairs" and "points": its two parts, the pair launch's and the
      diagonal launch's;
    * "block", the former one-launch kernel's: every pair's three blocks,
      4 N^3 and 3 N^2;
    * "dense": 8 N^3 and 4 N^2 per pair."""
    nz, P, Np = ops.Em1.shape
    N = Np // 2
    mat, vec = {
        "least": (2 * N ** 3 * n_pairs + N ** 3 * n_points,
                  2 * N ** 2 * n_pairs + N ** 2 * n_points),
        "pairs": (2 * N ** 3 * n_pairs, 2 * N ** 2 * n_pairs),
        "points": (N ** 3 * n_points, N ** 2 * n_points),
        "block": (4 * N ** 3 * P, 3 * N ** 2 * P),
        "dense": (Np ** 3 * P, Np ** 2 * P)}[count]
    n_mat = sum(2 * k + 5 for k in ns_sched) + 2 * ns_inter + 11
    n_vec = 4 * len(ns_sched) + 4
    return 2.0 * (n_mat * mat + n_vec * vec) * nz


def timed_once(fn):
    """(fn(), its device time in ms): one call between two CUDA events,
    for a launch too long to repeat whose code has run before."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def mt_errors(outs, refs):
    """K2 against its plain version over several moments: (the primal's
    max|d| / max|ref| over outputs, [per parameter: max|d| over every
    tangent output and moment / that parameter's max|ref| over the same],
    max|d| of all)."""
    e_prim = max(rel(a, b) for (p, _), (r, _) in zip(outs, refs)
                 for a, b in zip(p, r))
    e_tan = []
    for q in range(refs[0][1][0].shape[0]):
        d = max(float((a[q] - b[q]).abs().max())
                for (_, t), (_, r) in zip(outs, refs) for a, b in zip(t, r))
        scale = max(float(b[q].abs().max()) for _, r in refs for b in r)
        e_tan.append(d / scale if scale > 0 else d)
    e_abs = max(float((a - b).abs().max()) for o, r in zip(outs, refs)
                for a, b in zip((*o[0], *o[1]), (*r[0], *r[1])))
    return e_prim, e_tan, e_abs


def tangent_f64_errors(args, outs, refs):
    """K2's tangents over several launches (``multitangent_args`` each)
    against the plain version run in f64 on the same operands: per
    parameter, (the kernel's max|d| / that parameter's f64 max over every
    tangent output and launch, the f32 plain version's)."""
    from vsmartmom_tpu_torch.ops import fused_lin
    r64 = [fused_lin.moment_multitangent_reference(
        ops._replace(**{f: getattr(ops, f).double() for f in ops._fields}),
        dops._replace(**{f: getattr(dops, f).double()
                         for f in dops._fields}), sched, inter)[1]
        for ops, dops, sched, inter in args]

    def dist(xs, q):
        return max(float((a[q].double() - b[q]).abs().max())
                   for x, r in zip(xs, r64) for a, b in zip(x[1], r))
    errs = []
    for q in range(r64[0][0].shape[0]):
        scale = max(float(t[q].abs().max()) for r in r64 for t in r)
        scale = scale if scale > 0 else 1.0
        errs.append((dist(outs, q) / scale, dist(refs, q) / scale))
    return errs


def f64_errors(ops, sched, inter, kernel, plain):
    """One moment's composite against the plain version run in f64 on the
    same operands (``BandOperands``): (the kernel's max|d| / max|ref| over
    outputs, the f32 plain version's), to tell rounding from a less
    accurate route."""
    from vsmartmom_tpu_torch.ops import fused_band
    ref = fused_band.moment_body_reference(
        ops._replace(**{f: getattr(ops, f).double() for f in ops._fields}),
        sched, inter)
    return (max(rel(a.double(), b) for a, b in zip(kernel, ref)),
            max(rel(a.double(), b) for a, b in zip(plain, ref)))


def primal_f64_errors(args, kernel, plain):
    """``f64_errors`` of K2's primal (``multitangent_args``)."""
    ops, _, sched, inter = args
    return f64_errors(ops, sched, inter, kernel, plain)


def band_f64_errors(args, kw, kernel, plain):
    """``f64_errors`` of one K1 launch (``band_moment_args``)."""
    from vsmartmom_tpu_torch.ops import fused_band
    ops = fused_band.band_operands(*args, **{
        k: kw[k] for k in ("ndoubl", "n_stokes", "i_mu0_start",
                           "n_sources")})
    sched = fused_band.norm_sched(kw["ns_sched"] or None, kw["ndoubl"])
    return f64_errors(ops, sched, kw["ns_inter"], kernel, plain)


def layer_flops(N, K, ns_sched, ns_inter=None):
    """FP32 operations per point of one doubling ladder (K5) or, with
    ``ns_inter``, one whole layer step (K4): per ladder step with k NS
    iterations (2k + 5) N x N products and 4 K vector columns, per adding
    step (2 ns_inter + 11) N x N products and 4 K columns; 2 N^2 per
    product column."""
    cols = sum((2 * k + 5) * N + 4 * K for k in ns_sched)
    if ns_inter is not None:
        cols += (2 * ns_inter + 11) * N + 4 * K
    return 2.0 * N * N * cols


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


class DeviceSplit:
    """Device time of chosen functions inside one solve: each wrapped call
    is bracketed by CUDA events (nested calls count in both)."""

    def __init__(self):
        self.spans = {}

    def wrap(self, name, fn):
        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.spans.setdefault(name, []).append((e0, e1))
            return out
        return timed

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.spans.items()}


class K5Paths:
    """Which ladder each K5 launch of a run took. Per launch: its points (one
    block each), how many of them the kernel's vote sends down the O(N)
    path (r all zero and t diagonal, counted on the launch's operands on
    the device) and the launch's device time (CUDA events around
    ``fused_rt._launch_doubling``)."""

    def __init__(self):
        self.spans = []

    def wrap(self, fn):
        def traced(r, t, *rest):
            nonzero = (t != 0).sum((1, 2))
            diag = (t.diagonal(dim1=1, dim2=2) != 0).sum(1)
            z0 = ((r == 0).flatten(1).all(1) & (nonzero == diag)).sum()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(r, t, *rest)
            e1.record()
            self.spans.append((r.shape[0], z0, e0, e1))
            return out
        return traced

    def summary(self):
        """Launches whose every block took the O(N) path, whose none did,
        and the rest, each with its device times (ms)."""
        torch.cuda.synchronize()
        out = {"z0": [], "dense": [], "mixed": []}
        for points, z0, e0, e1 in self.spans:
            z0 = int(z0)
            kind = ("z0" if z0 == points else "dense" if z0 == 0
                    else "mixed")
            out[kind].append(e0.elapsed_time(e1))
        return out


def best_of(fn, reps=3):
    """Host seconds of fn() (synchronised): (best of ``reps`` after a
    warm-up, all of them)."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times[1:]), times


@contextlib.contextmanager
def timed_calls(module, name):
    """``module.<name>`` wrapped for the block: the host seconds of each
    call, synchronised before and after, go into the list it yields (the
    solve inside an entry run timed without a run of its own)."""
    fn, times = getattr(module, name), []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    setattr(module, name, timed)
    try:
        yield times
    finally:
        setattr(module, name, fn)


def launch_counted():
    """Every kernel wrapper of the port by name; each carries its launch
    count in ``.launches``."""
    from vsmartmom_tpu_torch.ops import band_stages, fused_band, fused_lin, \
        fused_rrs, fused_rt, probe_dots, probe_layout
    return {"fused_moment": fused_band.fused_moment,
            "fused_moment_cluster": fused_band._launch_cluster,
            "fused_moment_rrs": fused_rrs.fused_moment_rrs,
            "rrs_diagonal": fused_rrs._launch_diagonal,
            "fused_moment_multitangent": fused_lin.fused_moment_multitangent,
            "fused_moment_multitangent_wide": fused_lin._launch_wide,
            "fused_doubling": fused_rt.fused_doubling,
            "fused_layer_step": fused_rt.fused_layer_step,
            "dot_chain": probe_dots.dot_chain,
            "lane_dot_chain": probe_dots.lane_dot_chain,
            "layout_op": probe_layout.layout_op,
            "band_stages": band_stages.band_stages,
            "band_chain": band_stages._launch_chain}


def ms_phase(dev, smi):
    """The multisensor path: K5 against its plain version at the flagship's
    stash shape, ``rt_run_ms`` of the flagship (nSpec 1024, levels 0, 16,
    33) and of the MS bench scene (nSpec 256, levels 0, 4, 8) with every
    launch counter set to 0 just before and read just after, the kernel
    route against the plain (LU) route per level and level 0 against the
    band path's rt_solve, then timing. Returns K5's kernels-line entry."""
    from vsmartmom_tpu_torch import flagship_model, rrs_sif_model, rt_run_ms
    from vsmartmom_tpu_torch.core import multisensor, solver
    from vsmartmom_tpu_torch.core.types import SolverInputs
    from vsmartmom_tpu_torch.ops import cuda_build, fused_rt
    counted = launch_counted()

    scenes = {"flagship": (flagship_model(n_spec=MS_N_SPEC), MS_LEVELS),
              "rrs_sif": (rrs_sif_model(n_spec=MS_RRS_N_SPEC),
                          MS_RRS_LEVELS)}
    built = {k: m.build_band(0, device=dev) for k, (m, _) in scenes.items()}
    inputs, config = built["flagship"]
    if not config.fused:
        fail("the flagship f32 model on CUDA did not pick the kernel route")
    sched = fused_rt.norm_sched(config.ns_sched or None, config.ndoubl)
    inp = SolverInputs(*(x.to(torch.float32) for x in inputs))

    # K5 against its plain version at moment 0 (every layer scatters: the
    # dense ladder, <= 1e-4 and the f64 gate) and at moment m_max (Z = 0
    # above m_scat: the O(N) path, bit for bit, r exactly zero).
    k5_abs_err, k5_ops, k5_f64 = 0.0, {}, None
    for m in (0, config.m_max):
        layer_data, kw = multisensor.layer_batch_args(inp, config, m)
        d = kw.pop("d_vec")[:, None]
        r_mp, t_pp, jp, jm, expk = solver.layer_batch(layer_data, **kw)
        ops = (r_mp * d, t_pp, jp, jm * d, expk)
        out = fused_rt.fused_doubling(*ops, config.ndoubl, ns_sched=sched)
        torch.cuda.synchronize()
        ref = fused_rt.doubling_reference(*ops, config.ndoubl, sched)
        errs = {n: rel(a, b) for n, a, b in zip(("r", "t", "jp", "jm"),
                                                out, ref)}
        k5_abs_err = max([k5_abs_err] + [float((a - b).abs().max())
                                         for a, b in zip(out, ref)])
        line = f"K5 vs plain m={m} ({r_mp.shape[0]} points): " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items())
        if m <= config.m_scat:
            ref64 = fused_rt.doubling_reference(
                *(x.double() for x in ops), config.ndoubl, sched)
            k5_f64 = (max(rel(a.double(), b) for a, b in zip(out, ref64)),
                      max(rel(a.double(), b) for a, b in zip(ref, ref64)))
            line += (f"; vs f64 plain: kernel {k5_f64[0]:.2e}, f32 plain "
                     f"{k5_f64[1]:.2e}")
        else:
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            line += f"; bit for bit {same}"
        print(line, flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"fused_doubling vs doubling_reference at m={m}: {errs}")
        if m <= config.m_scat and not k5_f64[0] <= F64_RATIO * k5_f64[1]:
            fail(f"fused_doubling at m={m} is {k5_f64[0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain version's {k5_f64[1]}")
        if m > config.m_scat and not (same and bool((out[0] == 0).all())):
            fail(f"K5 at m={m} (Z = 0) not bit-identical to plain, or r "
                 "not exactly zero")
        k5_ops[m] = ops
        del out, ref

    result = {}
    for name, (model, levels) in scenes.items():
        inputs, config = built[name]
        paths = K5Paths()
        launch_doubling = fused_rt._launch_doubling
        fused_rt._launch_doubling = paths.wrap(launch_doubling)
        try:
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            uwJ, dwJ = rt_run_ms(model, levels, device=dev)
            torch.cuda.synchronize()
            e2e_s = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counted.items()}
        finally:
            fused_rt._launch_doubling = launch_doubling
        k5_paths = paths.summary()
        want = {k: 0 for k in counted}
        want["fused_doubling"] = config.m_max + 1
        print(f"main path: rt_run_ms {name} nSpec={config.n_spec} levels "
              f"{levels}, launches {launches} (want {want}), {e2e_s:.1f} s",
              flush=True)
        if launches != want:
            fail(f"rt_run_ms {name} launches {launches}, want {want}")
        # The O(N) path shows in the device time: a launch whose every
        # block voted for it runs in well under a quarter of a dense one.
        print("K5 paths in that run (by the operands' vote): " + " ".join(
            f"{k} {len(v)} launches ({', '.join(f'{x:.3f}' for x in v)} "
            "ms)" for k, v in k5_paths.items()), flush=True)
        if sum(map(len, k5_paths.values())) != launches["fused_doubling"]:
            fail(f"rt_run_ms {name}: K5 spans {k5_paths} do not match "
                 f"{launches['fused_doubling']} launches")
        if k5_paths["z0"] and k5_paths["dense"] and \
                max(k5_paths["z0"]) > 0.25 * min(k5_paths["dense"]):
            fail(f"rt_run_ms {name}: a Z = 0 launch took "
                 f"{max(k5_paths['z0'])} ms against a dense launch's "
                 f"{min(k5_paths['dense'])} ms: not the O(N) path")
        shape = (len(levels), len(config.vza_idx), config.n_stokes,
                 config.n_spec)
        if uwJ.shape != shape or not (np.isfinite(uwJ).all()
                                      and np.isfinite(dwJ).all()):
            fail(f"rt_run_ms {name}: not finite or shape {uwJ.shape}")
        plain = multisensor.rt_solve_ms(
            inputs, dataclasses.replace(config, fused=False), levels, dev)
        e_route = {f"{k}[{L}]": rel(v[i], plain[k][i].cpu())
                   for k, v in (("uwJ", uwJ), ("dwJ", dwJ))
                   for i, L in enumerate(levels)}
        band = solver.rt_solve(inputs, config, dev)
        e_band = {"uwJ[0]-R": rel(uwJ[0], band["R"].cpu()),
                  "dwJ[0]-T": rel(dwJ[0], band["T"].cpu())}
        print(f"MS {name}: kernel route vs plain route " + " ".join(
            f"{k}={e:.2e}" for k, e in e_route.items()) + "; level 0 vs "
            "band rt_solve " + " ".join(f"{k}={e:.2e}"
                                        for k, e in e_band.items()),
            flush=True)
        if not all(e <= GATE for e in (*e_route.values(),
                                       *e_band.values())):
            fail(f"MS {name} gates: {e_route} {e_band}")

        solve_s, times = best_of(lambda: multisensor.rt_solve_ms(
            inputs, config, levels, dev), reps=2)
        split = DeviceSplit()
        patched = [(solver, "fused_doubling"),
                   (multisensor, "_make_added_layer"),
                   (multisensor, "interaction"),
                   (multisensor, "interlayer_flux")]
        saved = [getattr(mod, attr) for mod, attr in patched]
        for mod, attr in patched:
            setattr(mod, attr, split.wrap(attr, getattr(mod, attr)))
        try:
            t0 = time.perf_counter()
            multisensor.rt_solve_ms(inputs, config, levels, dev)
            split_ms = split.ms()
            split_ms["solve"] = (time.perf_counter() - t0) * 1e3
        finally:
            for (mod, attr), fn in zip(patched, saved):
                setattr(mod, attr, fn)
        result[name] = {
            "ms_pts_per_s": config.n_spec / solve_s, "ms_solve_s": solve_s,
            "ms_solve_all_s": times, "rt_run_ms_e2e_s": e2e_s,
            "n_spec": config.n_spec, "levels": levels, "launches": launches,
            "k5_paths_ms": k5_paths,
            "device_split_ms": {
                "stash (elemental + K5)": split_ms["_make_added_layer"],
                "K5": split_ms["fused_doubling"],
                "interactions": split_ms["interaction"],
                "interlayer_flux": split_ms.get("interlayer_flux", 0.0),
                "solve (host clock)": split_ms["solve"]}}

    inputs, config = built["flagship"]
    # K5 per launch at moment 0 (the dense ladder, bound by operations:
    # layer_flops) and at m_max (Z = 0: the O(N) ladder, 7 K + 1 operations
    # a row and step, bound by the bytes of its operands and outputs).
    k5 = {}
    for m, ops in k5_ops.items():
        ms = cuda_time_ms(lambda: fused_rt._launch_doubling(*ops, sched),
                          reps=3)
        plain_ms = cuda_time_ms(lambda: fused_rt.doubling_reference(
            *ops, config.ndoubl, sched), reps=2)
        out = fused_rt._launch_doubling(*ops, sched)
        n_pts = ops[0].shape[0]
        if m <= config.m_scat:
            flops = layer_flops(config.N, config.n_sources, sched) * n_pts
        else:
            flops = (7.0 * config.n_sources + 1) * config.N \
                * config.ndoubl * n_pts
        nb = nbytes(*ops, *out)
        ops_ms = flops / FP32_PEAK_FLOPS * 1e3
        mem_ms = nb / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, mem_ms)
        k5[m] = {"m": m, "points": n_pts, "kernel_ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
                 "bound_share": bound / ms, "flops": flops, "bytes": nb,
                 "launches": len(result["flagship"]["k5_paths_ms"][
                     "dense" if m <= config.m_scat else "z0"])}
        del out
    dense, z0 = k5[0], k5[config.m_max]
    dense["f64_kernel_plain"] = k5_f64
    lib = cuda_build.load("fused_rt")
    blocks_per_sm = {K: lib.vsm_fused_doubling_blocks_per_sm(config.N, K)
                     for K in (1, 2)}
    print(json.dumps({"card": smi, "ms": result,
                      "k5_launch": {"dense": dense, "z0": z0,
                                    "blocks_per_sm": blocks_per_sm}}),
          flush=True)
    return {"name": "fused_doubling", "route": "cuda",
            "source": "vsmartmom_tpu_torch/csrc/fused_rt.cu",
            "replaces": "vsmartmom_tpu/ops/fused_rt.py:425",
            "launches": result["flagship"]["launches"]["fused_doubling"],
            "max_abs_err": k5_abs_err, "ms": dense["kernel_ms"],
            "plain_ms": dense["plain_ms"], "bound_ms": dense["bound_ms"],
            "bound_by": dense["bound_by"], "library_ms": None,
            "z0": {k: z0[k] for k in ("m", "launches", "kernel_ms",
                                      "plain_ms", "bound_ms", "bound_by")}}


def layer_chain_phase(dev, smi, inputs, config):
    """K4 on the flagship chain of scripts/probe_fused2.py: the flagship's
    own elemental operators of moments 0..m_scat at nSpec 1024 chained
    through ``fused_layer_step`` over all layers from the vacuum composite
    (launch counters set to 0 just before, read just after), held against
    the plain chain and K1's composite of the same moment; timing of the
    chain beside K1's launches for the same moments. Returns K4's
    kernels-line entry."""
    from vsmartmom_tpu_torch.core import multisensor, solver
    from vsmartmom_tpu_torch.core.kernels import identity_composite
    from vsmartmom_tpu_torch.core.types import SolverInputs
    from vsmartmom_tpu_torch.ops import fused_band, fused_rt
    counted = launch_counted()
    inputs, config = solver.spectral_slice(inputs, config, 0, N_CHUNK)
    inp = SolverInputs(*(x.to(torch.float32) for x in inputs))
    nz, s, N, K = config.nz, N_CHUNK, config.N, config.n_sources
    sched = fused_rt.norm_sched(config.ns_sched or None, config.ndoubl)
    layers = []
    for m in range(config.m_scat + 1):
        layer_data, kw = multisensor.layer_batch_args(inp, config, m)
        d = kw.pop("d_vec")
        r_mp, t_pp, jp, jm, expk = (
            x.reshape(nz, s, *x.shape[1:])
            for x in solver.layer_batch(layer_data, **kw))
        layers.append((r_mp * d[:, None], t_pp, jp, jm * d[:, None], expk,
                       d))

    def chain(step, dtype=torch.float32):
        comps = []
        for lay in layers:
            r, t, jp, jm, ek, d = (x.to(dtype) for x in lay)
            comp = identity_composite(s, N, dtype, dev, K)
            for z in range(nz):
                comp = step(comp, r[z], t[z], jp[z], jm[z], ek[z], d,
                            config.ndoubl, sched, config.ns_inter)
            comps.append(comp)
        return comps

    for fn in counted.values():
        fn.launches = 0
    out = chain(fused_rt.fused_layer_step)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    want = {k: 0 for k in counted}
    want["fused_layer_step"] = len(layers) * nz
    print(f"layer chain: moments 0..{config.m_scat} x {nz} layers at "
          f"nSpec={s}, launches {launches} (want {want})", flush=True)
    if launches != want:
        fail(f"layer chain launches {launches}, want {want}")
    plain = chain(fused_rt.layer_step_reference)
    plain64 = chain(fused_rt.layer_step_reference, torch.float64)
    names = ("R_mp", "R_pm", "T_pp", "T_mm", "J0_p", "J0_m")
    k4_abs_err = 0.0
    k4_f64 = []
    k1_args = [solver.band_moment_args(inputs, config, m, dev)
               for m in range(len(layers))]
    for m, (o, p, q, a) in enumerate(zip(out, plain, plain64, k1_args)):
        k1 = fused_band.fused_moment(*a[0], **a[1])
        e_p = {n: rel(x, y) for n, x, y in zip(names, o, p)}
        e_k1 = {n: rel(x, y) for n, x, y in zip(names, o, k1)}
        k4_abs_err = max([k4_abs_err] + [float((x - y).abs().max())
                                         for x, y in zip(o, p)])
        # The matrices round as the plain chain's; the sources (four
        # partial sums a row) within 2x of its distance from f64.
        same = [bool(torch.equal(x, y)) for x, y in zip(o[:4], p[:4])]
        e64 = (max(rel(x.double(), z) for x, z in zip(o[4:], q[4:])),
               max(rel(y.double(), z) for y, z in zip(p[4:], q[4:])))
        k4_f64.append(e64)
        print(f"K4 chain m={m} vs plain chain: " + " ".join(
            f"{n}={e:.2e}" for n, e in e_p.items()) + "; vs K1: " + " ".join(
            f"{n}={e:.2e}" for n, e in e_k1.items()) + "; matrices "
            f"bit-identical: {all(same)}; J vs f64 plain chain: kernel "
            f"{e64[0]:.2e}, f32 plain {e64[1]:.2e}", flush=True)
        if not all(np.isfinite(e) and e <= GATE
                   for e in (*e_p.values(), *e_k1.values())):
            fail(f"K4 chain at m={m}: vs plain {e_p}, vs K1 {e_k1}")
        if not all(same):
            fail(f"K4 chain's matrices at m={m} are not the plain chain's "
                 f"bit for bit: {dict(zip(names, same))}")
        if not e64[0] <= F64_RATIO * e64[1]:
            fail(f"K4 chain's sources at m={m} are {e64[0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain chain's {e64[1]}")

    chain_ms = cuda_time_ms(lambda: chain(fused_rt.fused_layer_step),
                            reps=3)
    k1_ms = cuda_time_ms(lambda: [fused_band.fused_moment(*a[0], **a[1])
                                  for a in k1_args], reps=3)
    r, t, jp, jm, ek, d = layers[0]
    z = nz // 2
    comp = out[0]
    k4_ms = chain_ms / want["fused_layer_step"]
    k4_plain_ms = cuda_time_ms(lambda: fused_rt.layer_step_reference(
        comp, r[z], t[z], jp[z], jm[z], ek[z], d, config.ndoubl, sched,
        config.ns_inter), reps=3)
    one = fused_rt._launch_layer_step(comp, r[z], t[z], jp[z], jm[z], ek[z],
                                      d, sched, config.ns_inter)
    k4_flops = layer_flops(N, K, sched, config.ns_inter) * s
    k4_bytes = nbytes(*comp, r[z], t[z], jp[z], jm[z], ek[z], d, *one)
    k4_ops_ms = k4_flops / FP32_PEAK_FLOPS * 1e3
    k4_mem_ms = k4_bytes / HBM_BYTES_PER_S * 1e3
    k4_bound = max(k4_ops_ms, k4_mem_ms)
    print(json.dumps({
        "card": smi, "layer_chain": {
            "moments": len(layers), "layers": nz, "n_spec": s,
            "k4_chain_ms": chain_ms, "k1_same_moments_ms": k1_ms,
            "k4_blocks_per_sm": fused_rt.layer_step_blocks_per_sm(N, K),
            "f64_kernel_plain_sources": k4_f64,
            "k4_launch": {"kernel_ms": k4_ms, "plain_ms": k4_plain_ms,
                          "bound_ms": k4_bound,
                          "bound_share": k4_bound / k4_ms,
                          "flops": k4_flops, "bytes": k4_bytes,
                          "achieved_tflops": k4_flops / k4_ms / 1e9}}}),
        flush=True)
    return {"name": "fused_layer_step", "route": "cuda",
            "source": "vsmartmom_tpu_torch/csrc/fused_rt.cu",
            "replaces": "vsmartmom_tpu/ops/fused_rt.py:493",
            "launches": launches["fused_layer_step"],
            "max_abs_err": k4_abs_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound,
            "bound_by": "operations" if k4_ops_ms >= k4_mem_ms else "bytes",
            "library_ms": None}


#: The wrapper each probe call site launches, and the source of its kernel.
PROBE_KERNELS = {
    "P1": "dot_chain", "P2": "dot_chain", "P3": "dot_chain",
    "P6": "dot_chain", "P8": "dot_chain", "P4": "lane_dot_chain",
    "P9": "lane_dot_chain", "P5": "layout_op", "P7": "band_stages"}
PROBE_SOURCES = {"dot_chain": "probe_dots.cu",
                 "lane_dot_chain": "probe_dots.cu",
                 "layout_op": "probe_layout.cu",
                 "band_stages": "band_stages.cu"}


def probe_failures(site, case):
    """The gates one probe case misses (``probes.common.chain_failures``
    for the dot and lane chains); every kernel time must be the device's
    work alone."""
    from vsmartmom_tpu_torch.probes import common
    bad = [] if case["device_only"]["kernel"] else [
        f"{case['case']}: the host did not queue the timed calls ahead"]
    if site == "P5":
        return bad + ([] if case["exact"] else [f"{case['case']}: not exact"])
    if site == "P7":
        if case["must_be_finite"] and case["finite_share"] != 1.0:
            bad.append(f"{case['case']}: plain version not finite "
                       f"({case['finite_share']})")
        if not (case["nan_match"] and case["err_plain"] <= common.GATE):
            bad.append(f"{case['case']}: NaN pattern {case['nan_match']}, "
                       f"{case['err_plain']} where finite")
        return bad
    return bad + common.chain_failures(case)


def mt_plan_report(config, n_par):
    """K2's launch plan at a Jacobian scene's (N, K, P), printed and
    returned: the host plan (``fused_lin.mt_plan``), which must be the C
    side's, the clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``, at least 1), ptxas's registers and
    spills of the K instance, the kernel's own work (groups + 2P primal
    moments a point) and the cluster barriers a block passes a launch (one
    a product phase: per layer 3 a doubling step, 2 a Newton-Schulz
    iteration, 6 + 2 ns_inter for the adding; one before the first remote
    store and one after the last)."""
    from vsmartmom_tpu_torch.ops import cuda_build, fused_lin
    from vsmartmom_tpu_torch.ops.fused_rt import norm_sched
    K = config.n_sources
    plan = fused_lin.mt_plan(config.N, K, n_par)
    info = fused_lin.mt_launch_info(config.N, K, n_par)
    report = ptxas_report(cuda_build.BUILD_LOG.get("fused_lin", (0, ""))[1])
    regs = [v for k, v in report.items() if f"mt_kernelILi{K}E" in k]
    regs, st, ld = regs[0] if regs else (None, None, None)
    sched = norm_sched(config.ns_sched or None, config.ndoubl)
    barriers = config.nz * (3 * config.ndoubl + 2 * sum(sched)
                            + 2 * config.ns_inter + 6) + 2
    out = {k: plan[k] for k in ("cluster", "groups", "threads", "smem",
                                "tiles", "work")}
    out.update(max_clusters=info["max_clusters"], registers=regs,
               spill_stores=st, spill_loads=ld, cluster_barriers=barriers)
    print(f"  plan K2 N={config.N} K={K} P={n_par}: {plan['groups']} "
          f"cluster(s) of {plan['cluster']} blocks a point, "
          f"{plan['threads']} threads, {plan['smem']} B shared, "
          f"{info['max_clusters']} clusters resident, {plan['tiles']} tiles "
          f"a product; mt_kernel<{K}>: {regs} registers, spills {st} / {ld} "
          f"B; {plan['work']} primal moments a point; {barriers} cluster "
          f"barriers a block", flush=True)
    bad = [k for k in ("cluster", "groups", "threads", "smem", "tiles")
           if info[k] != plan[k]]
    if bad or not info["max_clusters"] >= 1:
        fail(f"K2 plan {plan} against the C side's {info}")
    return out


def ptxas_report(log):
    """{kernel entry: (registers, spill store bytes, spill load bytes)} from
    nvcc's ``-Xptxas -v`` report of one library (the entry's own function
    properties, not those of a device function it calls)."""
    import re
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = props = m.group(1)
            out[entry] = [None, None, None]
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry and props == entry:
            out[entry][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry][0] = int(m.group(1))
    return out


def case_kernel(case):
    """The kernel entry a dot or lane case launches (its mangled-name
    fragment in ptxas's report)."""
    plan = case["plan"]
    if case["form"] == "lane":
        return "lane_chain_kernel"
    if case["mode"] == "fp32":
        return "simt_chain_kernel"
    from vsmartmom_tpu_torch.ops.probe_dots import tf32_depth
    mode = {"tf32": 1, "3xtf32": 2}[case["mode"]]
    return (f"wg_chain_kernelILi{mode}ELi{plan['cols']}"
            f"ELi{tf32_depth(case['shape'][1])}ELi{plan['rows'] // 64}E")


def plan_line(site, case, report):
    """One printed line of a case's launch plan, and the misses: the host
    plan must be the launch the C side makes of it."""
    plan = case["plan"]
    regs = [v for k, v in report.items() if case_kernel(case) in k]
    regs, st, ld = regs[0] if regs else (None, None, None)
    per_block = (plan["threads"] // 128 if case["mode"] != "fp32"
                 and case["form"] != "lane" else max(plan["points"], 1))
    slabs = (plan["blocks_per_sm"] * per_block
             if plan.get("blocks_per_sm") is not None else None)
    line = (f"  plan {site} {case['case']}: grid {tuple(plan['grid'])} "
            f"({plan['blocks']} blocks), {plan['threads']} threads, "
            f"{plan['smem']} B shared, {plan.get('blocks_per_sm')} "
            f"blocks/SM, {slabs} "
            f"{'points' if case['form'] == 'lane' else 'slabs'} in flight/SM; rows x cols {plan['rows']} x {plan['cols']}; "
            f"{case_kernel(case)}: {regs} registers, spills {st} / {ld} B")
    same = (plan.get("c_grid") == plan["grid"]
            and plan.get("c_threads") == plan["threads"]
            and plan.get("c_smem") == plan["smem"])
    bad = [] if same else [f"{case['case']}: host plan {plan} is not the "
                           f"C launch"]
    return line, bad


def band_plan_lines(cases):
    """The band-stage kernels' plan lines, one a P7 case: each launch's
    grid, threads and shared bytes (the C side's plan,
    ``band_stages.band_plan``) and its entry's ptxas registers and
    spills."""
    from vsmartmom_tpu_torch.ops import band_stages, cuda_build
    from vsmartmom_tpu_torch.probes import band_bisect
    report = ptxas_report(cuda_build.BUILD_LOG.get("band_stages",
                                                   (0, ""))[1])
    lines = []
    for case in cases:
        plan = band_stages.band_plan(case["stage"], case["nz"],
                                     band_bisect.S, band_bisect.N)
        parts = []
        for x in plan["launches"]:
            regs = [v for k, v in report.items() if x["kernel"] in k]
            regs, st, ld = regs[0] if regs else (None, None, None)
            parts.append(f"{x['kernel']} grid {x['grid']}, {x['threads']} "
                         f"threads, {x['smem']} B shared, {regs} registers, "
                         f"spills {st} / {ld} B")
        lines.append(f"  plan P7 {case['case']}: " + "; ".join(parts)
                     + f"; scratch {4 * plan['scratch']} B")
    return lines


def probe_entry(site, replaces, cases, launches):
    """The kernels-line entry of one probe call site: its headline case
    (the first fp32 case; P5 one pass over its sixteen cases; P7 the full
    stage where it is finite) and the largest kernel-vs-plain difference
    over all its cases."""
    if site == "P5":
        head = {k: sum(c[k] for c in cases)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        head.update(case="16 cases, one launch each", bound_by="bytes")
    elif site == "P7":
        head = next(c for c in cases if c["must_be_finite"])
    else:
        head = next(c for c in cases if c["mode"] == "fp32")
    wrapper = PROBE_KERNELS[site]
    return {"name": f"{wrapper}[{site}]", "route": "cuda",
            "source": "vsmartmom_tpu_torch/csrc/" + PROBE_SOURCES[wrapper],
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "case": head["case"]}


def probes_phase(smi):
    """P1-P9: each probe module run on the card at its script's shapes,
    every launch counter set to 0 just before and read just after (it
    must equal the wrapper calls each case made: one warm-up, REPS timed
    calls per try, its checks), its gates held, one JSON line per call
    site. Returns the nine kernels-line entries."""
    import importlib

    from vsmartmom_tpu_torch.ops import cuda_build
    from vsmartmom_tpu_torch.probes import SITES
    counted = launch_counted()
    report = ptxas_report(cuda_build.BUILD_LOG.get("probe_dots", (0, ""))[1])
    entries = []
    for module, sites in SITES.items():
        mod = importlib.import_module(f"vsmartmom_tpu_torch.probes.{module}")
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = mod.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        want = {k: 0 for k in counted}
        for site in sites:
            want[PROBE_KERNELS[site]] += sum(c["kernel_calls"]
                                             for c in result[site])
        # P7's full stage: a chain launch after each of its layer launches.
        want["band_chain"] = sum(c["kernel_calls"]
                                 for c in result.get("P7", [])
                                 if c["stage"] == "full")
        print(f"probes: {module} in {seconds:.1f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} } (want "
              f"{ {k: v for k, v in want.items() if v} })", flush=True)
        if launches != want:
            fail(f"probe {module} launches {launches}, want {want}")
        for site, replaces in sites.items():
            cases = result[site]
            print(json.dumps({"card": smi, "probe": site,
                              "replaces": replaces, "device": result["device"],
                              "cases": cases}), flush=True)
            bad = [m for c in cases for m in probe_failures(site, c)]
            for case in cases:
                if PROBE_KERNELS[site] in ("dot_chain", "lane_dot_chain"):
                    line, miss = plan_line(site, case, report)
                    print(line, flush=True)
                    bad += miss
            if site == "P7":
                print("\n".join(band_plan_lines(cases)), flush=True)
            if bad:
                fail(f"probe {site}: " + "; ".join(bad))
            entries.append(probe_entry(site, replaces, cases,
                                       launches[PROBE_KERNELS[site]]))
            if site == "P7":
                entries[-1]["chain_launches"] = launches["band_chain"]
    return entries


def ref_errors(out, ref, prefix, keys):
    """{key: max|d| / max|ref|} of a run's outputs against the stored
    reference's "<prefix>_<key>" arrays (a shape mismatch fails)."""
    errs = {}
    for k, v in zip(keys, out):
        if np.shape(v) != ref[f"{prefix}_{k}"].shape:
            fail(f"{prefix} {k} of shape {np.shape(v)}, the stored "
                 f"reference's {ref[f'{prefix}_{k}'].shape}")
        errs[k] = rel(v, ref[f"{prefix}_{k}"])
    return errs


def raman_phase(dev, smi):
    """The vibrational, stellar and multisensor Raman paths (see the module
    docstring, phase 10)."""
    from vsmartmom_tpu_torch import (rt_run_inelastic, rt_run_ms_rrs,
                                     rt_run_stellar)
    from vsmartmom_tpu_torch.core.inelastic import (
        _src_fixed0, inelastic_setup, raman_z_stack, rayleigh_fraction,
        rrs_moment_args, rt_solve_rrs, rt_solve_rrs_fused)
    from vsmartmom_tpu_torch.core.multisensor import (ie_stash_bytes,
                                                      rt_solve_ms_rrs)
    from vsmartmom_tpu_torch.core.types import rrs_setup_from_numpy
    from vsmartmom_tpu_torch.flagship import (
        MS_RRS_REF_LEVELS, ms_rrs_ref_model, rrs_sif_model,
        stellar_ref_model, stellar_sif_model, stellar_vs_sif_model,
        vs_ref_model, vs_sif_model)
    from vsmartmom_tpu_torch.inelastic.stellar import (
        get_raman_solar_constants, greek_raman_stellar,
        greek_raman_stellar_vs, sol_rrs_setup, sol_vs_redistribution)
    from vsmartmom_tpu_torch.inelastic.vs_setup import vs_redistribution
    from vsmartmom_tpu_torch.ops import fused_rrs
    keys = ("R", "T", "ieR", "ieT")
    data = Path(__file__).resolve().parent / "vsmartmom_tpu_torch" / "data"
    counted = launch_counted()
    phase_t0 = time.perf_counter()

    def run_counted(fn):
        for c in counted.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counted.items()
                     if c.launches}

    # (a) Vibrational Raman: the plain fixed-source solve on the card.
    vs_model = vs_sif_model("VS_0to1")
    nu = vs_model.bands[0].nu_grid
    w_vs, _, _ = vs_redistribution(nu, "VS_0to1")
    vs, vs_launches = run_counted(lambda: dict(zip(keys, rt_run_inelastic(
        vs_model, mode="VS_0to1", device=dev))))
    hit = w_vs > 0
    print(f"VS_0to1: nSpec={len(nu)} (incident {nu[0]} cm^-1), targets "
          f"with weight {int(hit.sum())}, launches {vs_launches} (want "
          f"none: plain); ieR max {np.abs(vs['ieR']).max():.4g}, ieR/R at "
          f"the targets {np.max(vs['ieR'][0, 0, hit] / vs['R'][0, 0, hit]):.3g}",
          flush=True)
    if vs_launches or not all(np.isfinite(v).all() for v in vs.values()):
        fail(f"VS run: launches {vs_launches}, or non-finite output")
    if not (np.all(vs["ieR"][:, :, 0] == 0.0)
            and np.all(vs["ieR"][:, 0, hit] > 0)):
        fail("VS ieR not zero at the incident point or not > 0 where the "
             "weight is")
    ref = np.load(data / "vs_ref_f64.npz")
    for mode in ("VS_0to1", "VS_1to0"):
        e = ref_errors(rt_run_inelastic(vs_ref_model(mode), mode=mode,
                                        device=dev), ref, mode, keys)
        print(f"{mode} small scene (plain, card) vs JAX f64 reference: "
              + " ".join(f"{k}={v:.2e}" for k, v in e.items()), flush=True)
        if not all(v <= GATE for v in e.values()):
            fail(f"{mode} port vs stored JAX reference: {e}")
    vs_inputs, vs_config, *vs_rrs = inelastic_setup(vs_model, mode="VS_0to1",
                                                    device=dev)
    vs_s, vs_all = best_of(lambda: rt_solve_rrs(
        vs_inputs, vs_config, *vs_rrs, device=dev, src_fn=_src_fixed0),
        reps=2)

    # (b) Stellar rotational Raman through K1 and K3 (full ie resolution).
    st_model = stellar_sif_model()
    st_nu = st_model.bands[0].nu_grid
    n_st = len(st_nu)
    st_inputs, st_config, *st = sol_rrs_setup(st_model, device=dev)
    if not st_config.fused:
        fail("the stellar f32 model on CUDA did not pick the kernel path")
    shifts = st[0]
    n_rc = min(len(shifts), 32768 // n_st)
    k3_args, k3_kw = rrs_moment_args(st_inputs, st_config, *st, 0, dev, True)
    sched = fused_rrs.norm_sched(k3_kw["ns_sched"], k3_kw["ndoubl"])
    k3_info = fused_rrs.launch_info(st_config.N, st_config.nz, sched,
                                    k3_kw["ns_inter"])
    print(f"stellar RRS config: N={st_config.N} nz={st_config.nz} "
          f"ndoubl={st_config.ndoubl} ns_sched={st_config.ns_sched} "
          f"ns_inter={st_config.ns_inter}; H2 shifts {list(shifts)}; ie "
          f"ladder (full) ndoubl={k3_kw['ndoubl']} ns_sched={sched}; K3 "
          f"launches {json.dumps(k3_info)}", flush=True)
    if not (k3_kw["ndoubl"] == st_config.ndoubl and
            k3_info["pair_smem_bytes"] == fused_rrs.pair_smem_bytes(
                st_config.N, k3_info["pool"]) <= fused_rrs.SMEM_LIMIT):
        fail(f"K3's stellar plan: {k3_info}")
    st_out, st_launches = run_counted(lambda: dict(zip(keys, rt_run_stellar(
        st_model, device=dev))))
    n_m = st_config.m_max + 1
    want = {"fused_moment": n_m,
            "fused_moment_rrs": n_m * -(-len(shifts) // n_rc),
            "rrs_diagonal": n_m * -(-len(shifts) // n_rc)}
    print(f"main path: rt_run_stellar sol_RRS nSpec={n_st}, launches "
          f"{st_launches} (want {want})", flush=True)
    if st_launches != want:
        fail(f"stellar RRS launches {st_launches}, want {want}")
    shape = (len(st_config.vza_idx), st_config.n_stokes, n_st)
    if not all(np.isfinite(v).all() and v.shape == shape
               for v in st_out.values()):
        fail("stellar RRS output not finite or of the wrong shape")
    plain = rt_solve_rrs(st_inputs, dataclasses.replace(st_config,
                                                        fused=False),
                         *st, device=dev)
    e_route = {k: rel(st_out[k], plain[k].cpu()) for k in keys}
    ratio = st_out["ieR"][0, 0] / st_out["R"][0, 0]
    i_core = int(np.argmin(st_model.bands[0].f0_spec))
    fill_in = float(ratio[i_core] - np.median(ratio[n_st // 8:-n_st // 8]))
    print("stellar RRS kernel path (full ie) vs plain path: " + " ".join(
        f"{k}={v:.2e}" for k, v in e_route.items()) + f"; Ring fill-in at "
        f"the dip (ieR/R at the core minus its median) {fill_in:.4g}",
        flush=True)
    if not (e_route["R"] <= GATE and e_route["ieR"] <= GATE
            and fill_in > 0):
        fail(f"stellar RRS route vs plain {e_route}, fill-in {fill_in}")
    ref = np.load(data / "stellar_ref_f64.npz")
    e = ref_errors(rt_run_stellar(stellar_ref_model(), device=dev), ref,
                   "sol_RRS", keys)
    print("sol_RRS small scene (kernel path) vs JAX f64 reference: "
          + " ".join(f"{k}={v:.2e}" for k, v in e.items()), flush=True)
    if not (e["R"] <= GATE and e["ieR"] <= GATE):
        fail(f"sol_RRS port vs stored JAX reference: {e}")
    st_s, st_all = best_of(lambda: rt_solve_rrs_fused(
        st_inputs, st_config, *st, device=dev, ie_fullres=True))
    ops = fused_rrs.rrs_operands(*k3_args, **{
        k: v for k, v in k3_kw.items() if k not in ("ns_sched", "ns_inter")})
    _, pairs, _ = fused_rrs.kernel_plan(ops, shifts, sched,
                                        k3_kw["ns_inter"])
    k3_ms = cuda_time_ms(lambda: fused_rrs._launch_kernel(
        ops, shifts, sched, k3_kw["ns_inter"]), reps=3)
    k3_plain_ms = cuda_time_ms(lambda: fused_rrs.moment_rrs_body_reference(
        ops, sched, k3_kw["ns_inter"]), reps=2)
    out = fused_rrs._launch_kernel(ops, shifts, sched, k3_kw["ns_inter"])
    n_on = int(pairs.shape[0])
    k3_flops = rrs_flops(ops, n_st, n_on, sched, k3_kw["ns_inter"])
    k3_bytes = nbytes(*ops) + nbytes(*out)
    t_ops, t_bytes = k3_flops / FP32_PEAK_FLOPS * 1e3, \
        k3_bytes / HBM_BYTES_PER_S * 1e3
    k3_bound = max(t_ops, t_bytes)

    # (c) Stellar vibrational Raman: two plain fixed-source passes.
    sv_model = stellar_vs_sif_model("sol_VS_0to1")
    sv_nu = sv_model.bands[0].nu_grid
    sv, sv_launches = run_counted(lambda: dict(zip(keys, rt_run_stellar(
        sv_model, mode="sol_VS_0to1", device=dev))))
    print(f"sol_VS_0to1: nSpec={len(sv_nu)}, launches {sv_launches} (want "
          f"none: plain), ieR max {np.abs(sv['ieR']).max():.4g}", flush=True)
    if sv_launches or not all(np.isfinite(v).all() for v in sv.values()) \
            or not np.abs(sv["ieR"][:, :, 1:]).max() > 0:
        fail(f"stellar VS run: launches {sv_launches}, non-finite or no ie")
    for mode in ("sol_VS_0to1", "sol_VS_1to0"):
        e = ref_errors(rt_run_stellar(stellar_ref_model(mode), mode=mode,
                                      device=dev), ref, mode, keys)
        print(f"{mode} small scene (plain, card) vs JAX f64 reference: "
              + " ".join(f"{k}={v:.2e}" for k, v in e.items()), flush=True)
        if not all(v <= GATE for v in e.values()):
            fail(f"{mode} port vs stored JAX reference: {e}")
    sv_inputs, sv_config = sv_model.build_band(0, device=dev, rrs=True)
    band = sv_model.bands[0]
    w_rvrs, w_vrs, _, _ = sol_vs_redistribution(band.nu_grid, "sol_VS_0to1")
    h2 = get_raman_solar_constants(float(band.nu_grid[0]))
    passes = [rrs_setup_from_numpy(
        (0,), w[None, :], *raman_z_stack(sv_model, sv_config, g),
        rayleigh_fraction(band), dev)
        for w, g in ((w_rvrs, greek_raman_stellar()),
                     (w_vrs, greek_raman_stellar_vs(h2)))]
    sv_s, sv_all = best_of(lambda: [rt_solve_rrs(
        sv_inputs, sv_config, *p, device=dev, src_fn=_src_fixed0)
        for p in passes], reps=2)

    # (d) Multisensor Raman: the MS bench scene, plain torch on the card.
    ms_model = rrs_sif_model(n_spec=MS_RRS_N_SPEC)
    ms_inputs, ms_config, *ms = inelastic_setup(ms_model, device=dev)
    n_r = len(ms[0])
    stash = ie_stash_bytes(ms_config, n_r)
    dims = (ms_config.nz, n_r, MS_RRS_N_SPEC, ms_config.N, ms_config.N)
    print(f"MS-RRS: nSpec={MS_RRS_N_SPEC} levels {MS_RRS_LEVELS} shifts "
          f"{n_r}; the per-layer ie stash of one moment: four matrix fields "
          f"of (nz, nR, nSpec, N, N) = {dims} and two source fields of "
          f"{dims[:-1]}, {stash} B ({stash / 2 ** 30:.3f} GiB)", flush=True)
    msr, ms_launches = run_counted(lambda: rt_run_ms_rrs(
        ms_model, MS_RRS_LEVELS, device=dev))
    if ms_launches or not all(np.isfinite(v).all() for v in msr):
        fail(f"MS-RRS run: launches {ms_launches}, or non-finite output")
    plain = rt_solve_rrs(ms_inputs, dataclasses.replace(ms_config,
                                                        fused=False),
                         *ms, device=dev)
    e_lvl0 = {k: rel(v[0], plain[p].cpu()) for k, v, p in zip(
        ("uwJ", "dwJ", "ieuwJ", "iedwJ"), msr, keys)}
    print("MS-RRS level 0 vs plain rt_solve_rrs (card): " + " ".join(
        f"{k}={v:.2e}" for k, v in e_lvl0.items()), flush=True)
    if not all(v <= GATE for v in e_lvl0.values()):
        fail(f"MS-RRS level 0 vs rt_solve_rrs: {e_lvl0}")
    ref = np.load(data / "ms_rrs_ref_f64.npz")
    for mode in ("RRS", "VS_0to1"):
        e = ref_errors(rt_run_ms_rrs(ms_rrs_ref_model(mode),
                                     MS_RRS_REF_LEVELS, mode=mode,
                                     device=dev),
                       ref, mode, ("uwJ", "dwJ", "ieuwJ", "iedwJ"))
        print(f"MS-RRS {mode} small scene (levels {MS_RRS_REF_LEVELS}) vs "
              "JAX f64 reference: " + " ".join(f"{k}={v:.2e}"
                                               for k, v in e.items()),
              flush=True)
        if not all(v <= GATE for v in e.values()):
            fail(f"MS-RRS {mode} port vs stored JAX reference: {e}")
    torch.cuda.reset_peak_memory_stats(dev)
    ms_s, ms_all = best_of(lambda: rt_solve_ms_rrs(
        ms_inputs, ms_config, MS_RRS_LEVELS, *ms, device=dev), reps=2)
    print(json.dumps({
        "card": smi, "vs_pts_per_s": len(nu) / vs_s, "vs_solve_s": vs_s,
        "vs_solve_all_s": vs_all, "vs_n_spec": len(nu),
        "stellar_rrs_pts_per_s": n_st / st_s, "stellar_rrs_solve_s": st_s,
        "stellar_rrs_solve_all_s": st_all, "stellar_n_spec": n_st,
        "stellar_vs_pts_per_s": len(sv_nu) / sv_s,
        "stellar_vs_solve_s": sv_s, "stellar_vs_solve_all_s": sv_all,
        "stellar_vs_n_spec": len(sv_nu),
        "ms_rrs_pts_per_s": MS_RRS_N_SPEC / ms_s, "ms_rrs_solve_s": ms_s,
        "ms_rrs_solve_all_s": ms_all, "ms_rrs_stash_bytes": stash,
        "ms_rrs_peak_bytes": torch.cuda.max_memory_allocated(dev),
        "phase_s": time.perf_counter() - phase_t0,
        "rrs_launch_stellar": {
            "n_spec": n_st, "shifts": len(shifts), "pairs": len(shifts) * n_st,
            "pairs_on_grid": n_on, "phases": sched, "kernel_ms": k3_ms,
            "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": k3_bound / k3_ms, "flops": k3_flops,
            "bytes": k3_bytes, "plan": k3_info}}), flush=True)


def lin_ref_gates(out, ref, names):
    """A Jacobian run against a stored JAX f64 reference: ({R, T, dR, dT}
    errors, each parameter's dR error on its own scale, the height
    parameters' 1.01 control, whether the gates hold): R <= 1e-4, each dR
    <= 2e-4 of its own max (HEIGHT_GATE for the aerosol height), and the
    height Jacobians 1% off must fail their gate. The stored dR is the JAX
    package's, which leaves out the Cox-Munk TMS term's derivative through
    each tangent's optical depth; the port's carries it, so the gate adds
    the stored ``dR_tms`` (that term from the JAX tangents) to it."""
    ref = {**{k: ref[k] for k in ("R", "T", "dT")},
           "dR": ref["dR"] + ref["dR_tms"]}
    e = {k: rel(out[k], ref[k]) for k in ("R", "T", "dR", "dT")}
    own = [rel(out["dR"][..., q], ref["dR"][..., q])
           for q in range(len(names))]
    gates = [HEIGHT_GATE if n.endswith(HEIGHT_PARAMS) else TAN_GATE
             for n in names]
    control = [rel(1.01 * out["dR"][..., q], ref["dR"][..., q])
               for q, n in enumerate(names) if n.endswith(HEIGHT_PARAMS)]
    ok = (e["R"] <= GATE and all(x <= g for x, g in zip(own, gates))
          and all(x > HEIGHT_GATE for x in control))
    return e, own, control, ok


def thermal_lin_phase(dev, smi):
    """The thermal (K = 2) Jacobian path through K1' (see the module
    docstring, phase 8). Returns K1''s kernels-line entry."""
    import ctypes

    from vsmartmom_tpu_torch import (default_layout, rt_run, rt_run_lin,
                                     thermal_lin_model)
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        rt_solve_jvp)
    from vsmartmom_tpu_torch.core.solver import spectral_slice
    from vsmartmom_tpu_torch.flagship import lin_thermal_model
    from vsmartmom_tpu_torch.ops import cuda_build, fused_band, fused_lin
    counted = launch_counted()
    phase_t0 = time.perf_counter()

    smem_fn = cuda_build.load("fused_lin").vsm_fused_moment_mt_smem_bytes
    smem_fn.restype = ctypes.c_size_t
    smem_fn.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = {k: smem_fn(fused_lin.NARROW_MAX_N, k) for k in (1, 2)}
    print(f"K2 shared memory at N={fused_lin.NARROW_MAX_N}: K=1 {smem[1]} B,"
          f" K=2 {smem[2]} B (opt-in limit {SMEM_OPT_IN} B)", flush=True)
    if smem[2] > SMEM_OPT_IN:
        fail(f"K2 at K = 2 needs {smem[2]} B of shared memory")

    t0 = time.perf_counter()
    model = thermal_lin_model(THERMAL_N_SPEC)
    scene_s = time.perf_counter() - t0
    layout = default_layout(model)
    t0 = time.perf_counter()
    inputs, config, tans = build_tangent_inputs(model, 0, layout, device=dev)
    torch.cuda.synchronize()
    tangent_s = time.perf_counter() - t0
    n_par = len(tans)
    if not (config.fused and config.n_sources == 2 and config.N == 52
            and n_par == 8):
        fail(f"the thermal scene on CUDA: fused={config.fused}, "
             f"K={config.n_sources}, N={config.N}, P={n_par}")
    print(f"thermal Jacobian config: N={config.N} nz={config.nz} "
          f"C={inputs.Z_pp.shape[1]} K={config.n_sources} "
          f"ndoubl={config.ndoubl} ns_sched={config.ns_sched} "
          f"ns_inter={config.ns_inter} m_max={config.m_max} "
          f"m_scat={config.m_scat} params={layout.names()}; "
          f"max B={model.bands[0].thermal_b.max():.4g}; host build "
          f"{scene_s:.1f} s, tangents {tangent_s:.1f} s", flush=True)
    sl = spectral_slice(inputs, config, 0, THERMAL_SLICE)
    sl_tans = [spectral_slice(t, config, 0, THERMAL_SLICE)[0] for t in tans]

    # K1' against its plain version; the thermal column at m > 0 is zero.
    outs, refs, th_max, f64_errs = [], [], 0.0, []
    for m in (0, 1, config.m_max):
        args = fused_lin.multitangent_args(sl[0], sl_tans, sl[1], m, dev)
        outs.append(fused_lin.fused_moment_multitangent(*args))
        torch.cuda.synchronize()
        refs.append(fused_lin.moment_multitangent_reference(*args))
        f64_errs.append(primal_f64_errors(args, outs[-1][0], refs[-1][0]))
        (*_, Jp, Jm), (*_, dJp, dJm) = outs[-1]
        th = [x[..., 1] for x in (Jp, Jm, dJp, dJm)]
        if m == 0:
            th_max = max(float(th[0].abs().max()), float(th[1].abs().max()))
            if not th_max > 0:
                fail("K1' gave no thermal signal at m = 0")
        elif not all(bool((x == 0).all()) for x in th):
            fail(f"K1' gave a non-zero thermal column at m = {m}")
    k1p_prim, k1p_tan, k1p_abs_err = mt_errors(outs, refs)
    del outs, refs
    print(f"K1' vs plain (nSpec={THERMAL_SLICE}, m=0,1,{config.m_max}): "
          f"primal={k1p_prim:.2e} tangents per parameter "
          + " ".join(f"{e:.2e}" for e in k1p_tan)
          + f"; thermal column max at m=0 {th_max:.4g}, exactly 0 above"
          f"; primal vs f64 plain: kernel {max(e[0] for e in f64_errs):.2e},"
          f" f32 plain {max(e[1] for e in f64_errs):.2e}", flush=True)
    if not (np.isfinite(k1p_prim) and k1p_prim <= GATE
            and all(np.isfinite(e) and e <= TAN_GATE for e in k1p_tan)):
        fail(f"K1' vs moment_multitangent_reference: primal {k1p_prim}, "
             f"tangents {k1p_tan}")

    # The main path, counted.
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with timed_calls(fused_lin, "rt_solve_multitangent") as solve_times:
        R, T, dR, dT = rt_run_lin(model, layout=layout, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    want = {k: 0 for k in counted}
    want["fused_moment_multitangent"] = config.m_scat + 1
    print(f"main path: thermal rt_run_lin nSpec={THERMAL_N_SPEC}, K=2, "
          f"{n_par} parameters, launches {launches} (want {want}), "
          f"{e2e_s:.1f} s", flush=True)
    if launches != want:
        fail(f"thermal Jacobian path launches {launches}, want {want}")
    if dR.shape != (9, 4, THERMAL_N_SPEC, n_par) or not all(
            np.isfinite(x).all() for x in (R, T, dR, dT)):
        fail(f"thermal rt_run_lin not finite or dR of shape {dR.shape}")
    # The routes and the additivity on moments 0..ROUTE_CHECK_M (the jvp
    # route is launch-bound; K1' was held to its plain version above).
    cut = dataclasses.replace(sl[1], m_max=min(config.m_max, ROUTE_CHECK_M))
    kern = fused_lin.rt_solve_multitangent(sl[0], sl_tans, cut, dev)
    plain = rt_solve_jvp(sl[0], sl_tans,
                         dataclasses.replace(cut, fused=False), dev)
    e_route = [rel(kern[0], plain[0])] + [rel(kern[2][q], plain[2][q])
                                          for q in range(n_par)]
    print(f"thermal kernel route vs jvp route (nSpec={THERMAL_SLICE}, "
          f"m=0..{cut.m_max}): "
          f"R={e_route[0]:.2e} dR per parameter "
          + " ".join(f"{e:.2e}" for e in e_route[1:])
          + f"; dT={rel(kern[3], plain[3]):.2e}", flush=True)
    if not (e_route[0] <= GATE and all(e <= TAN_GATE for e in e_route[1:])):
        fail(f"thermal kernel route vs jvp route: {e_route}")
    del plain
    fused_band.fused_moment.launches = 0
    R_fwd, _ = rt_run(model, device=dev, spectral_chunk=THERMAL_N_SPEC)
    e_fwd = rel(R, R_fwd)
    print(f"rt_run of the thermal scene: fused_moment launches="
          f"{fused_band.fused_moment.launches} (want {config.m_scat + 1}, "
          f"K=2), R vs rt_run_lin's R {e_fwd:.2e}", flush=True)
    if fused_band.fused_moment.launches != config.m_scat + 1 \
            or not e_fwd <= GATE:
        fail(f"rt_run vs rt_run_lin on the thermal scene: {e_fwd}")

    # Additivity: the RT is linear in its sources. The solar-only and the
    # thermal-only (include_solar=False) bands of the same scene, with the
    # same tangents (they carry none of F0 or thermal_b).
    band, th_b = model.bands[0], model.bands[0].thermal_b
    band.thermal_b = None
    sol = model.build_band(0, device=dev)
    band.thermal_b = th_b
    model.params.include_solar = False
    therm = model.build_band(0, device=dev)
    model.params.include_solar = True
    if not (sol[1].n_sources == 1 and therm[1].n_sources == 2
            and not bool(therm[0].F0.any())
            and sol[1].ns_sched == therm[1].ns_sched == config.ns_sched):
        fail("the solar-only and thermal-only builds of the thermal scene")
    parts = []
    for b in (sol, therm):
        b_inputs, b_config = spectral_slice(*b, 0, THERMAL_SLICE)
        parts.append(fused_lin.rt_solve_multitangent(
            b_inputs, sl_tans, dataclasses.replace(b_config,
                                                   m_max=cut.m_max), dev))
    e_add = [rel(parts[0][0] + parts[1][0], kern[0])] + [
        rel(parts[0][2][q] + parts[1][2][q], kern[2][q])
        for q in range(n_par)]
    share = float(parts[1][0].abs().max() / kern[0].abs().max())
    print(f"additivity (nSpec={THERMAL_SLICE}): R={e_add[0]:.2e} dR per "
          "parameter " + " ".join(f"{e:.2e}" for e in e_add[1:])
          + f"; thermal-only max R / total {share:.3f}", flush=True)
    if not (e_add[0] <= GATE and all(e <= TAN_GATE for e in e_add[1:])
            and share > 1e-3):
        fail(f"additivity of the sources: {e_add}, thermal share {share}")
    del kern, parts

    # Against the JAX package: the small thermal scene's stored f64 run.
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "lin_thermal_ref_f64.npz")
    small_model = lin_thermal_model()
    small = dict(zip(("R", "T", "dR", "dT"),
                     rt_run_lin(small_model, device=dev)))
    names = default_layout(small_model).names()
    e_ref, own, control, ok = lin_ref_gates(small, ref, names)
    print("thermal Jacobian kernel path vs JAX f64 reference (small thermal "
          "scene): " + " ".join(f"{k}={e:.2e}" for k, e in e_ref.items())
          + "; dR per parameter on its own scale "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(names, own))
          + "; height dR 1% off " + " ".join(f"{e:.2e}" for e in control),
          flush=True)
    if not ok:
        fail(f"thermal Jacobian port vs stored JAX reference: {e_ref}, per "
             f"parameter {own}, control {control}")

    # Timing: the solve inside the counted rt_run_lin above (K1' loaded
    # by the checks before it).
    if len(solve_times) != 1:
        fail(f"thermal rt_run_lin made {len(solve_times)} multitangent "
             "solves")
    solve_s = solve_times[0]
    args = fused_lin.multitangent_args(inputs, tans, config, 0, dev)
    k_ms = cuda_time_ms(lambda: fused_lin._launch_kernel(*args), reps=3)
    p_ms = cuda_time_ms(
        lambda: fused_lin.moment_multitangent_reference(*args), reps=2)
    out = fused_lin._launch_kernel(*args)
    plan = mt_plan_report(config, n_par)
    primal_flops = moment_flops(config, THERMAL_N_SPEC)
    flops = (1 + 2 * n_par) * primal_flops
    n_bytes = nbytes(*args[0], *args[1], *out[0], *out[1])
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, \
        n_bytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(json.dumps({
        "card": smi, "lin_thermal_pts_per_s": THERMAL_N_SPEC / solve_s,
        "lin_thermal_tangent_pts_per_s": THERMAL_N_SPEC * n_par / solve_s,
        "lin_thermal_solve_s": solve_s,
        "rt_run_lin_thermal_e2e_s": e2e_s, "scene_build_s": scene_s,
        "tangent_build_s": tangent_s, "n_spec": THERMAL_N_SPEC,
        "n_params": n_par, "launches": launches,
        "smem_bytes_k2": smem[2], "phase_s": time.perf_counter() - phase_t0,
        "k1prime_launch": {"n_spec": THERMAL_N_SPEC, "kernel_ms": k_ms,
                           "plain_ms": p_ms, "bound_ms": bound,
                           "bound_share": bound / k_ms, "flops": flops,
                           "flops_kernel": plan["work"] * primal_flops,
                           "bytes": n_bytes,
                           "achieved_tflops": flops / k_ms / 1e9,
                           "achieved_tflops_kernel": plan["work"]
                           * primal_flops / k_ms / 1e9,
                           "plan": plan}}), flush=True)
    return {"name": "fused_moment_multitangent[K1']", "route": "cuda",
            "source": "vsmartmom_tpu_torch/csrc/fused_lin.cu",
            "replaces": "vsmartmom_tpu/ops/fused_band.py:469",
            "launches": launches["fused_moment_multitangent"],
            "max_abs_err": k1p_abs_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def aband_slice(tau_abs_col, width, n_spec):
    """Start of the ``width``-point slice of an ``n_spec``-point band that
    holds its strongest line: centred on the largest column tau_abs."""
    return int(np.clip(np.argmax(tau_abs_col) - width // 2, 0,
                       n_spec - width))


def absorption_phase(dev, smi):
    """The gas path: the device line sum and the O2 A-band scene through K1
    and, with its VMR Jacobian, K2 at P = 2 (see the module docstring,
    phase 9)."""
    from vsmartmom_tpu_torch import default_layout, rt_run, rt_run_lin
    from vsmartmom_tpu_torch.absorption.cross_section import (
        HitranModel, absorption_profile, cross_sections)
    from vsmartmom_tpu_torch.absorption.hitran import read_hitran
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        rt_solve_jvp)
    from vsmartmom_tpu_torch.core.solver import (band_moment_args, rt_solve,
                                                 spectral_slice)
    from vsmartmom_tpu_torch.flagship import (aband_model, aband_ref_model,
                                              write_aband_par)
    from vsmartmom_tpu_torch.ops import fused_band, fused_lin
    counted = launch_counted()
    phase_t0 = time.perf_counter()

    # 1. The line sum on the card: the scene, then its line sum alone.
    par = write_aband_par()
    t0 = time.perf_counter()
    model = aband_model(ABAND_N_SPEC, device=dev, par_path=par)
    scene_s = time.perf_counter() - t0
    band, profile = model.bands[0], model.profile
    ap = model.params.absorption_params
    hmodel = HitranModel(hitran=read_hitran(
        par, nu_min=band.nu_grid.min() - ap.wing_cutoff,
        nu_max=band.nu_grid.max() + ap.wing_cutoff),
        wing_cutoff=ap.wing_cutoff)
    build_times = []
    for _ in range(4):                           # 1 warm-up + best of 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tau_dev = absorption_profile(hmodel, band.nu_grid, ap.vmr["O2"],
                                     profile, dev)
        torch.cuda.synchronize()
        build_times.append(time.perf_counter() - t0)
    absorption_s = min(build_times[1:])
    col = band.tau_abs.sum(axis=1)
    e_dev = rel(tau_dev.cpu(), torch.as_tensor(band.tau_abs_by_mol["O2"]))
    print(f"A-band scene: nSpec={ABAND_N_SPEC} nz={profile.nz} "
          f"{len(hmodel.hitran)} lines; host build {scene_s:.2f} s, device "
          f"line sum {absorption_s * 1e3:.2f} ms (best of 3 of "
          f"{[round(t, 4) for t in build_times]} s); tau_abs max "
          f"{band.tau_abs.max():.4g}, points with column tau_abs > 1: "
          f"{(col > 1).mean():.4f}; repeat vs build {e_dev:.2e}", flush=True)
    if not (band.tau_abs.max() > 10.0 and 0.0 < (col > 1).mean() < 1.0
            and np.isfinite(band.tau_abs).all() and e_dev <= 1e-10):
        fail(f"A-band line sum: max {band.tau_abs.max()}, repeat {e_dev}")

    # 2. The line sum on the card against the CPU, top, middle and bottom.
    layers = [0, profile.nz // 2, profile.nz - 1]
    p_l, t_l = profile.p_full[layers], profile.T[layers]
    sig_dev = cross_sections(hmodel, band.nu_grid, p_l, t_l, device=dev)
    sig_cpu = cross_sections(hmodel, band.nu_grid, p_l, t_l, device="cpu")
    e_cpu = [rel(sig_dev[k].cpu(), sig_cpu[k]) for k in range(len(layers))]
    print(f"line sum card vs CPU (f64, layers {layers}): "
          + " ".join(f"{e:.2e}" for e in e_cpu), flush=True)
    if not all(e <= 1e-10 for e in e_cpu):
        fail(f"line sum on the card vs the CPU: {e_cpu}")

    # 3. K1 against its plain version on the slice of the strongest lines.
    inputs, config = model.build_band(0, device=dev)
    if not config.fused:
        fail("the A-band f32 model on CUDA did not pick the band kernel")
    print(f"A-band config: N={config.N} nz={config.nz} ndoubl="
          f"{config.ndoubl} ns_sched={config.ns_sched} ns_inter="
          f"{config.ns_inter} m_scat={config.m_scat} m_max={config.m_max}",
          flush=True)
    a = aband_slice(col, N_CHUNK, ABAND_N_SPEC) // N_CHUNK * N_CHUNK
    strong = spectral_slice(inputs, config, a, a + N_CHUNK)
    names = ("R_mp", "R_pm", "T_pp", "T_mm", "J0_p", "J0_m")
    for m in range(config.m_scat + 1):
        args = band_moment_args(*strong, m, dev)
        out = fused_band.fused_moment(*args[0], **args[1])
        torch.cuda.synchronize()
        ref = fused_band.moment_reference(*args[0], **args[1])
        errs = {n: rel(x, y) for n, x, y in zip(names, out, ref)}
        e64 = band_f64_errors(*args, out, ref)
        print(f"K1 vs plain on A-band operands (points {a}-{a + N_CHUNK}, "
              f"m={m}): " + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
              + f"; vs f64 plain: kernel {e64[0]:.2e}, f32 plain "
              f"{e64[1]:.2e}", flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"K1 vs plain on A-band operands at m={m}: {errs}")
        if not e64[0] <= F64_RATIO * e64[1]:
            fail(f"K1 on A-band operands at m={m} is {e64[0]} from f64, "
                 f"over {F64_RATIO}x the f32 plain version's {e64[1]}")

    # 4. rt_run of the A-band scene, counted; kernel vs plain on every chunk.
    for fn in counted.values():
        fn.launches = 0
    R, T = rt_run(model, device=dev, spectral_chunk=N_CHUNK)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    want = {k: 0 for k in counted}
    want["fused_moment"] = (ABAND_N_SPEC // N_CHUNK) * (config.m_scat + 1)
    print(f"main path: A-band rt_run nSpec={ABAND_N_SPEC}, launches "
          f"{launches} (want {want})", flush=True)
    if launches != want:
        fail(f"A-band rt_run launches {launches}, want {want}")
    if R.shape != (9, 4, ABAND_N_SPEC) or not (np.isfinite(R).all()
                                               and np.isfinite(T).all()):
        fail(f"A-band R/T not finite or of the wrong shape {R.shape}")
    e_chunks = []
    for c in range(0, ABAND_N_SPEC, N_CHUNK):
        sl = spectral_slice(inputs, config, c, c + N_CHUNK)
        kern = rt_solve(*sl, dev)
        plain = rt_solve(sl[0], dataclasses.replace(
            sl[1], fused=False, m_scat=-1, ns_sched=(), ns_inter=6), dev)
        e_chunks.append({k: rel(kern[k], plain[k]) for k in ("R", "T")})
    print("A-band kernel path vs plain path per chunk: " + "; ".join(
        f"{i}: R={e['R']:.2e} T={e['T']:.2e}"
        for i, e in enumerate(e_chunks)), flush=True)
    if not all(e <= GATE for c in e_chunks for e in c.values()):
        fail(f"A-band kernel path vs plain path: {e_chunks}")
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "aband_ref_f64.npz")
    small_model = aband_ref_model(device=dev, par_path=par)
    R_s, T_s = rt_run(small_model, device=dev)
    e_ref = {"R": rel(R_s, ref["R"]), "T": rel(T_s, ref["T"])}
    print("A-band kernel path vs JAX f64 reference (small A-band scene): "
          + " ".join(f"{k}={e:.2e}" for k, e in e_ref.items()), flush=True)
    if not all(e <= GATE for e in e_ref.values()):
        fail(f"A-band port vs stored JAX reference: {e_ref}")

    # 5. The gas Jacobian: rt_run_lin at nSpec 1024, P = 2, counted.
    t0 = time.perf_counter()
    lin_model = aband_model(ABAND_LIN_N_SPEC, device=dev, par_path=par)
    lin_scene_s = time.perf_counter() - t0
    layout = default_layout(lin_model)
    lin_inputs, lin_config, tans = build_tangent_inputs(lin_model, 0, layout,
                                                        device=dev)
    n_par = len(tans)
    if layout.names() != ["vmr_O2", "wind_speed"] or not lin_config.fused:
        fail(f"the gas Jacobian scene: {layout.names()}, fused="
             f"{lin_config.fused}")
    print(f"gas Jacobian config: N={lin_config.N} nz={lin_config.nz} "
          f"ndoubl={lin_config.ndoubl} ns_sched={lin_config.ns_sched} "
          f"ns_inter={lin_config.ns_inter} m_scat={lin_config.m_scat} "
          f"params={layout.names()}", flush=True)
    k2_plan = mt_plan_report(lin_config, n_par)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    R, T, dR, dT = rt_run_lin(lin_model, layout=layout, device=dev)
    torch.cuda.synchronize()
    lin_e2e_s = time.perf_counter() - t0
    lin_launches = {k: fn.launches for k, fn in counted.items()}
    want = {k: 0 for k in counted}
    want["fused_moment_multitangent"] = lin_config.m_scat + 1
    print(f"main path: A-band rt_run_lin nSpec={ABAND_LIN_N_SPEC}, {n_par} "
          f"parameters, launches {lin_launches} (want {want}), "
          f"{lin_e2e_s:.1f} s", flush=True)
    if lin_launches != want:
        fail(f"gas Jacobian launches {lin_launches}, want {want}")
    if dR.shape != (9, 4, ABAND_LIN_N_SPEC, n_par) or not all(
            np.isfinite(x).all() for x in (R, T, dR, dT)):
        fail(f"gas rt_run_lin not finite or dR of shape {dR.shape}")
    lin_col = lin_model.bands[0].tau_abs.sum(axis=1)
    a = aband_slice(lin_col, ABAND_SLICE, ABAND_LIN_N_SPEC)
    sl = spectral_slice(lin_inputs, lin_config, a, a + ABAND_SLICE)
    sl_tans = [spectral_slice(t, lin_config, a, a + ABAND_SLICE)[0]
               for t in tans]
    kern = fused_lin.rt_solve_multitangent(sl[0], sl_tans, sl[1], dev)
    plain = rt_solve_jvp(sl[0], sl_tans,
                         dataclasses.replace(sl[1], fused=False), dev)
    e_route = [rel(kern[0], plain[0])] + [rel(kern[2][q], plain[2][q])
                                          for q in range(n_par)]
    print(f"gas Jacobian kernel route vs jvp route (points {a}-"
          f"{a + ABAND_SLICE}, column tau_abs {lin_col[a:a + ABAND_SLICE].min():.3g}"
          f"-{lin_col[a:a + ABAND_SLICE].max():.3g}): R={e_route[0]:.2e} dR "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(layout.names(),
                                                    e_route[1:]))
          + f"; dT={rel(kern[3], plain[3]):.2e}", flush=True)
    if not (e_route[0] <= GATE and all(e <= TAN_GATE for e in e_route[1:])):
        fail(f"gas Jacobian kernel route vs jvp route: {e_route}")
    del kern, plain
    R_fwd, _ = rt_run(lin_model, device=dev, spectral_chunk=ABAND_LIN_N_SPEC)
    e_fwd = rel(R, R_fwd)
    print(f"rt_run of the gas Jacobian scene: R vs rt_run_lin's R "
          f"{e_fwd:.2e}", flush=True)
    if not e_fwd <= GATE:
        fail(f"rt_run vs rt_run_lin on the gas Jacobian scene: {e_fwd}")
    small_names = default_layout(small_model).names()
    small = dict(zip(("R", "T", "dR", "dT"),
                     rt_run_lin(small_model, device=dev)))
    e_lref, own, _, ok = lin_ref_gates(small, ref, small_names)
    print("gas Jacobian kernel path vs JAX f64 reference (small A-band "
          "scene): " + " ".join(f"{k}={e:.2e}" for k, e in e_lref.items())
          + "; dR per parameter on its own scale "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(small_names, own)),
          flush=True)
    if not (ok and small_names == ["vmr_O2", "wind_speed"]):
        fail(f"gas Jacobian port vs stored JAX reference: {e_lref}, per "
             f"parameter {own}")

    # 6. Timing.
    chunks = [spectral_slice(inputs, config, c, c + N_CHUNK)
              for c in range(0, ABAND_N_SPEC, N_CHUNK)]
    times = []
    for _ in range(4):                           # 1 warm-up + best of 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [rt_solve(i, c, dev)["R"] for i, c in chunks]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            fail("non-finite R in the timed A-band solve")
    lin_times = []
    for _ in range(3):                           # 1 warm-up + best of 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fused_lin.rt_solve_multitangent(lin_inputs, tans, lin_config,
                                            dev)
        torch.cuda.synchronize()
        lin_times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(o[2]).all()):
            fail("non-finite dR in the timed gas Jacobian solve")
    del o
    args = fused_lin.multitangent_args(lin_inputs, tans, lin_config, 0, dev)
    k2_ms = cuda_time_ms(lambda: fused_lin._launch_kernel(*args), reps=3)
    k2_plain_ms = cuda_time_ms(
        lambda: fused_lin.moment_multitangent_reference(*args), reps=2)
    out = fused_lin._launch_kernel(*args)
    primal_flops = moment_flops(lin_config, ABAND_LIN_N_SPEC)
    k2_flops = (1 + 2 * n_par) * primal_flops
    k2_bytes = nbytes(*args[0], *args[1], *out[0], *out[1])
    t_ops, t_bytes = k2_flops / FP32_PEAK_FLOPS * 1e3, \
        k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_bound = max(t_ops, t_bytes)
    print(json.dumps({
        "card": smi, "aband_pts_per_s": ABAND_N_SPEC / min(times[1:]),
        "aband_solve_s": min(times[1:]), "aband_solve_all_s": times,
        "aband_lin_pts_per_s": ABAND_LIN_N_SPEC / min(lin_times[1:]),
        "aband_lin_solve_s": min(lin_times[1:]),
        "aband_lin_solve_all_s": lin_times,
        "rt_run_lin_aband_e2e_s": lin_e2e_s,
        "absorption_build_s": absorption_s,
        "absorption_build_all_s": build_times, "scene_build_s": scene_s,
        "lin_scene_build_s": lin_scene_s, "n_lines": len(hmodel.hitran),
        "n_spec": ABAND_N_SPEC, "lin_n_spec": ABAND_LIN_N_SPEC,
        "n_params": n_par, "launches": launches,
        "lin_launches": lin_launches,
        "phase_s": time.perf_counter() - phase_t0,
        "mt_launch_p2": {"n_spec": ABAND_LIN_N_SPEC, "kernel_ms": k2_ms,
                         "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
                         "bound_by": "operations" if t_ops >= t_bytes
                         else "bytes", "bound_share": k2_bound / k2_ms,
                         "flops": k2_flops,
                         "flops_kernel": k2_plan["work"] * primal_flops,
                         "bytes": k2_bytes, "plan": k2_plan}}), flush=True)


def geoschem_phase(dev, smi):
    """The GEOS-Chem column path: synthetic GCHP collections -> the TOML
    scene file -> ``Parameters`` -> ``model_from_parameters`` -> ``rt_run``
    through K1 (see the module docstring, phase 11)."""
    import tempfile

    from vsmartmom_tpu_torch import rt_run
    from vsmartmom_tpu_torch.aerosols import read_aerosol_data
    from vsmartmom_tpu_torch.core.solver import (band_moment_args, rt_solve,
                                                 spectral_slice)
    from vsmartmom_tpu_torch.flagship import (
        GEOSCHEM_REF_N_LEV, GEOSCHEM_REF_SPECIES, GEOSCHEM_SPECIES,
        geoschem_aerosol_config,
        geoschem_model, geoschem_ref_model, write_geoschem_column)
    from vsmartmom_tpu_torch.ops import fused_band
    counted = launch_counted()
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        # 1. The collections, then the user's build, timed (file reads,
        # to_rt_aerosols, the Mie builds and build_band, synchronised).
        files = write_geoschem_column(d)
        small = write_geoschem_column(d, n_lev=GEOSCHEM_REF_N_LEV,
                                      species=GEOSCHEM_REF_SPECIES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = geoschem_model(GEOSCHEM_N_SPEC, files=files, device=dev,
                               validate=False)
        inputs, config = model.build_band(0, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        band = model.bands[0]
        tau = band.tau_rayl + band.tau_abs + sum(
            c.tau_profile[None, :] for c in band.aerosols)
        n_comp = 1 + len(band.aerosols)
        print(f"GEOS-Chem scene (synthetic GCHP collections, column "
              f"(idx, idy, idf) (1, 2, 3); front end validate=False: no "
              f"jsonschema on this machine): nSpec={GEOSCHEM_N_SPEC} "
              f"nz={config.nz} C={n_comp} N={config.N} ndoubl="
              f"{config.ndoubl} ns_sched={config.ns_sched} ns_inter="
              f"{config.ns_inter} m_scat={config.m_scat} m_max="
              f"{config.m_max}; aerosol tau_ref "
              + " ".join(f"{a.tau_ref:.4f}" for a in
                         model.params.scattering_params.rt_aerosols)
              + f"; max layer tau {tau.max():.4g}, max dtau "
              f"{tau.max() / 2 ** config.ndoubl:.3g}; build {build_s:.2f} s",
              flush=True)
        if not (config.fused and config.nz == 72 and n_comp == 4
                and config.N == 52 and np.isfinite(tau).all()):
            fail(f"GEOS-Chem scene: fused={config.fused} nz={config.nz} "
                 f"C={n_comp} N={config.N}")

        # 2. The profiles read from GCHP's order against the (lev, time)
        # twin, exactly, for both scenes' collections.
        for fs, species in ((files, tuple(GEOSCHEM_SPECIES)),
                            (small, GEOSCHEM_REF_SPECIES)):
            cfg = geoschem_aerosol_config(species)
            a = read_aerosol_data(cfg, fs["aerosols"])
            b = read_aerosol_data(cfg, fs["aerosols_lev_time"])
            same = all(np.array_equal(v, b.species_data[sp].data[k])
                       for sp, dd in a.species_data.items()
                       for k, v in dd.data.items())
            print(f"aerosol profiles, GCHP order vs (lev, time) twin "
                  f"({len(a.species_data)} species, "
                  f"{len(next(iter(a.species_data.values())).data['aod'])} "
                  f"levels): {'equal' if same else 'DIFFER'}", flush=True)
            if not same:
                fail("aerosol profiles from GCHP's order differ from the "
                     "(lev, time) twin")

        # 3. rt_run, counted; kernel path vs plain path on the first chunk.
        for fn in counted.values():
            fn.launches = 0
        R, T = rt_run(model, device=dev, spectral_chunk=N_CHUNK)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counted.items()}
        want = {k: 0 for k in counted}
        want["fused_moment"] = (GEOSCHEM_N_SPEC // N_CHUNK) \
            * (config.m_scat + 1)
        print(f"main path: GEOS-Chem rt_run nSpec={GEOSCHEM_N_SPEC}, "
              f"launches {launches} (want {want})", flush=True)
        if launches != want:
            fail(f"GEOS-Chem rt_run launches {launches}, want {want}")
        if R.shape != (9, 4, GEOSCHEM_N_SPEC) or not (
                np.isfinite(R).all() and np.isfinite(T).all()):
            fail(f"GEOS-Chem R/T not finite or of the wrong shape {R.shape}")
        chunk0 = spectral_slice(inputs, config, 0, N_CHUNK)
        kern = rt_solve(*chunk0, dev)
        plain = rt_solve(chunk0[0], dataclasses.replace(
            chunk0[1], fused=False, m_scat=-1, ns_sched=(), ns_inter=6), dev)
        e_plain = {k: rel(kern[k], plain[k]) for k in ("R", "T")}
        names = ("R_mp", "R_pm", "T_pp", "T_mm", "J0_p", "J0_m")
        e_k1, abs_err = {}, 0.0
        for m in (0, config.m_scat):
            args = band_moment_args(*chunk0, m, dev)
            out = fused_band.fused_moment(*args[0], **args[1])
            torch.cuda.synchronize()
            ref = fused_band.moment_reference(*args[0], **args[1])
            e_k1[m] = max(rel(x, y) for x, y in zip(out, ref))
            abs_err = max([abs_err] + [float((x - y).abs().max())
                                       for x, y in zip(out, ref)])
        print(f"GEOS-Chem kernel path vs plain path (chunk 0): "
              f"R={e_plain['R']:.2e} T={e_plain['T']:.2e}; K1 vs plain "
              "per moment (max over " + ",".join(names) + "): "
              + " ".join(f"m={m}: {e:.2e}" for m, e in e_k1.items())
              + f" (max |d| {abs_err:.2e})", flush=True)
        if not (all(e <= GATE for e in e_plain.values())
                and all(e <= GATE for e in e_k1.values())):
            fail(f"GEOS-Chem kernel path vs plain path: {e_plain}, K1 "
                 f"{e_k1}")

        # 4. The small scene against the stored JAX f64 reference.
        ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                      / "data" / "geoschem_ref_f64.npz")
        for fn in counted.values():
            fn.launches = 0
        small_model = geoschem_ref_model(np.float32, files=small, device=dev)
        R_s, T_s = rt_run(small_model, device=dev)
        torch.cuda.synchronize()
        small_k1 = counted["fused_moment"].launches
        e_ref = {"R": rel(R_s, ref["R"]), "T": rel(T_s, ref["T"])}
        print("GEOS-Chem kernel path vs JAX f64 reference (small scene, "
              f"{GEOSCHEM_REF_N_LEV} levels, K1 launches {small_k1}): "
              + " ".join(f"{k}={e:.2e}" for k, e in e_ref.items()),
              flush=True)
        if not (small_k1 > 0 and all(e <= GATE for e in e_ref.values())):
            fail(f"GEOS-Chem port vs stored JAX reference: {e_ref}, K1 "
                 f"launches {small_k1}")

    # 5. Timing: the solve alone (best of 2 after a warm-up) and K1 a launch
    # at 72 layers and four components.
    chunks = [spectral_slice(inputs, config, c, c + N_CHUNK)
              for c in range(0, GEOSCHEM_N_SPEC, N_CHUNK)]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [rt_solve(i, c, dev)["R"] for i, c in chunks]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            fail("non-finite R in the timed GEOS-Chem solve")
    args = band_moment_args(*chunk0, 0, dev)
    k_ms = cuda_time_ms(lambda: fused_band.fused_moment(*args[0], **args[1]))
    p_ms = cuda_time_ms(
        lambda: fused_band.moment_reference(*args[0], **args[1]), reps=3)
    out = fused_band.fused_moment(*args[0], **args[1])
    flops = moment_flops(config, N_CHUNK)
    k1_bytes = moment_bytes(args, out)
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, \
        k1_bytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(json.dumps({
        "card": smi, "geoschem_pts_per_s": GEOSCHEM_N_SPEC / min(times[1:]),
        "geoschem_build_s": build_s, "geoschem_solve_s": min(times[1:]),
        "geoschem_solve_all_s": times, "n_spec": GEOSCHEM_N_SPEC,
        "nz": config.nz, "components": n_comp, "validate": False,
        "launches": launches, "max_abs_err": abs_err,
        "phase_s": time.perf_counter() - phase_t0,
        "moment_launch_nz72": {
            "n_spec": N_CHUNK, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "bound_share": bound / k_ms, "flops": flops,
            "bytes": k1_bytes, "achieved_tflops": flops / k_ms / 1e9}}),
        flush=True)


def per_parameter_errors(out, ref):
    """max|d| / max|ref| of each parameter (the trailing axes after the
    output's (nGeom, nStokes, S)) of a Jacobian, parameters with a zero
    reference left out: a list."""
    out = np.asarray(out).reshape(-1, *np.shape(out)[3:])
    ref = np.asarray(ref).reshape(-1, *np.shape(ref)[3:])
    out, ref = out.reshape(out.shape[0], -1), ref.reshape(ref.shape[0], -1)
    scale = np.abs(ref).max(axis=0)
    err = np.abs(out - ref).max(axis=0)
    return list(err[scale > 0] / scale[scale > 0])


def surfaces_phase(dev, smi):
    """The land and single-scatter paths: the vegetated red-edge column
    through ``rt_run_full`` (K1 on the atmosphere, the canopy surface after
    it), ``rt_run_ss`` on it, the standalone exact single scatter and the
    Gauss-Radau flagship (see the module docstring, phase 12)."""
    from vsmartmom_tpu_torch import (canopy_model, rt_run, rt_run_full,
                                     rt_run_ss)
    from vsmartmom_tpu_torch.core.singlescatter import rt_solve_ss
    from vsmartmom_tpu_torch.core.solver import (band_moment_args, rt_solve,
                                                 spectral_slice)
    from vsmartmom_tpu_torch.flagship import (canopy_ref_model,
                                              exact_ss_config, radau_model,
                                              surfaces_ref_outputs)
    from vsmartmom_tpu_torch.ops import fused_band
    from vsmartmom_tpu_torch.standalone_ss import (_on_device, _pack,
                                                   _ss_paths, run_exact_ss)
    counted = launch_counted()
    phase_t0 = time.perf_counter()
    stored = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                     / "data" / "surfaces_ref_f64.npz")

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in counted.items()}

    def against_stored(name, dtype=np.float32):
        out = surfaces_ref_outputs(name, dtype, dev)
        return {k[len(name) + 1:]: rel(v, stored[k]) for k, v in out.items()
                if np.abs(stored[k]).max() > 0}

    # 1. The canopy column: the user's build (the canopy's slab on the
    # card in f64, its operators interpolated on the host), timed, and its
    # surface stage read from the stage table (it ends on the host).
    from vsmartmom_tpu_torch.utils import timing
    timing.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = canopy_model(CANOPY_N_SPEC, device=dev)
    inputs, config = model.build_band(0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    surface_s = sum(timing._REGISTRY.get("surface[0]", [0.0]))
    print(f"canopy scene (SYNTHETIC leaf optics, RPV soil, solar spectrum, "
          f"SIF): nSpec={CANOPY_N_SPEC} nz={config.nz} N={config.N} "
          f"ndoubl={config.ndoubl} ns_sched={config.ns_sched} m_scat="
          f"{config.m_scat} m_max={config.m_max}; surf_r "
          f"{tuple(inputs.surf_r.shape)} on {inputs.surf_r.device}; build "
          f"{build_s:.2f} s, its surface stage {surface_s:.2f} s", flush=True)
    if not (config.fused and config.N == 52 and inputs.surf_r.dim() == 4
            and config.m_scat < config.m_max):
        fail(f"canopy scene: fused={config.fused} N={config.N} surf_r "
             f"{tuple(inputs.surf_r.shape)} m_scat={config.m_scat}")

    # 2. rt_run_full, counted: K1 for moments 0..m_scat of every chunk.
    zero()
    out = rt_run_full(model, device=dev, spectral_chunk=N_CHUNK)
    launches = read()
    want = {k: 0 for k in counted}
    want["fused_moment"] = (CANOPY_N_SPEC // N_CHUNK) * (config.m_scat + 1)
    print(f"main path: canopy rt_run_full nSpec={CANOPY_N_SPEC}, launches "
          f"{launches} (want {want})", flush=True)
    if launches != want:
        fail(f"canopy rt_run launches {launches}, want {want}")
    if out["R"].shape != (9, 4, CANOPY_N_SPEC) or not all(
            np.isfinite(out[k]).all() for k in ("R", "T", "hdr")):
        fail("canopy R, T or hdr not finite or of the wrong shape")
    chunk0 = spectral_slice(inputs, config, 0, N_CHUNK)
    kern = rt_solve(*chunk0, dev)
    plain = rt_solve(chunk0[0], dataclasses.replace(
        chunk0[1], fused=False, m_scat=-1, ns_sched=(), ns_inter=6), dev)
    e_plain = {k: rel(kern[k], plain[k]) for k in ("R", "T", "hdr")}
    args = band_moment_args(*chunk0, 0, dev)
    k1_out = fused_band.fused_moment(*args[0], **args[1])
    k1_ref = fused_band.moment_reference(*args[0], **args[1])
    e_k1 = max(rel(x, y) for x, y in zip(k1_out, k1_ref))
    print("canopy kernel path vs plain path (chunk 0; plain: every moment "
          "down the full path): " + " ".join(
              f"{k}={e:.2e}" for k, e in e_plain.items())
          + f"; K1 vs plain m=0 {e_k1:.2e}", flush=True)
    if not (all(e <= GATE for e in e_plain.values()) and e_k1 <= GATE):
        fail(f"canopy kernel path vs plain: {e_plain}, K1 {e_k1}")
    zero()
    e_ref = against_stored("canopy")
    small_k1 = read()["fused_moment"]
    print(f"canopy kernel path vs JAX f64 reference (small scene, K1 "
          f"launches {small_k1}): " + " ".join(
              f"{k}={e:.2e}" for k, e in e_ref.items()), flush=True)
    if not (small_k1 > 0 and all(e <= GATE for e in e_ref.values())):
        fail(f"canopy port vs stored JAX reference: {e_ref}")
    bare = rt_run_full(canopy_model(N_CHUNK, device=dev, soil_only=True),
                       device=dev)
    thin = rt_run_full(canopy_model(N_CHUNK, device=dev, LAI=1e-6),
                       device=dev)
    e_lai = {k: rel(thin[k], bare[k]) for k in ("R", "T", "hdr")}
    print(f"canopy LAI 1e-6 vs the bare RPV soil (nSpec {N_CHUNK}): "
          + " ".join(f"{k}={e:.2e}" for k, e in e_lai.items()), flush=True)
    if not all(e <= GATE for e in e_lai.values()):
        fail(f"canopy at LAI -> 0 differs from the soil: {e_lai}")

    # 3. rt_run_ss on the canopy column: no kernel; below the full solve.
    zero()
    ss = rt_run_ss(model, device=dev)
    ss_launches = read()
    print(f"rt_run_ss canopy nSpec={CANOPY_N_SPEC}: launches {ss_launches}",
          flush=True)
    if any(ss_launches.values()) or not all(
            np.isfinite(v).all() for v in ss.values()):
        fail(f"rt_run_ss: launches {ss_launches} or non-finite outputs")
    excess = float((ss["R"][:, 0] - out["R"][:, 0]).max()
                   / np.abs(out["R"][:, 0]).max())
    e_ss = {n: against_stored(n) for n in ("ss_canopy", "ss_coxmunk")}
    print(f"single scatter above the full solve's I by at most {excess:.2e} "
          "of max (gate 1e-4); small scenes vs JAX f64 reference: " + "; ".join(
              f"{n} " + " ".join(f"{k}={e:.2e}" for k, e in v.items())
              for n, v in e_ss.items()), flush=True)
    if not (excess <= GATE and all(e <= GATE for v in e_ss.values()
                                   for e in v.values())):
        fail(f"rt_run_ss: excess {excess}, stored {e_ss}")

    # 4. The standalone exact single scatter at the flagship's geometry.
    zero()
    cfg_all, _ = exact_ss_config(CANOPY_N_SPEC, "lambertian")
    cfg_cm, _ = exact_ss_config(CANOPY_N_SPEC, "coxmunk")
    ex_all = run_exact_ss(cfg_all, "all", device=dev)
    ex_cm = run_exact_ss(cfg_cm, "paths_1_2", device=dev)
    ex_launches = read()
    ex_ok = all(np.isfinite(r[k]).all() for r in (ex_all, ex_cm)
                for k in ("path1", "path2", "path3", "path4", "total"))
    e_ex, e_jac = {}, {}
    for name in ("exact_all", "exact_cm"):
        o = surfaces_ref_outputs(name, np.float64, dev)
        e_ex[name] = max(rel(o[f"{name}_{k}"], stored[f"{name}_{k}"])
                         for k in ("path1", "path2", "total"))
        e_jac[name] = max(max(per_parameter_errors(
            o[f"{name}_{k}"], stored[f"{name}_{k}"]) or [0.0])
            for k in ("d_tau", "d_ssa", "d_albedo"))
    print(f"run_exact_ss nSpec={CANOPY_N_SPEC} (33 layers, Rayleigh + HG): "
          f"all over Lambertian and paths_1_2 over Cox-Munk finite "
          f"{ex_ok}, launches {ex_launches}; small configs vs JAX f64 "
          "reference: " + " ".join(f"{k} {e:.2e}" for k, e in e_ex.items())
          + "; Jacobians, worst parameter: " + " ".join(
              f"{k} {e:.2e}" for k, e in e_jac.items()), flush=True)
    if not (ex_ok and not any(ex_launches.values())
            and all(e <= GATE for e in e_ex.values())
            and all(e <= TAN_GATE for e in e_jac.values())):
        fail(f"run_exact_ss: finite {ex_ok}, {e_ex}, Jacobians {e_jac}")

    # 5. The Radau flagship at IQU (N = 51): K1 against plain at every
    # moment, the counted run, the small scene against the stored one.
    r_model = radau_model(RADAU_N_SPEC)
    r_inputs, r_config = r_model.build_band(0, device=dev)
    if not (r_config.fused and r_config.N == 51):
        fail(f"Radau scene: fused={r_config.fused} N={r_config.N}")
    e_rk1 = []
    for m in range(r_config.m_scat + 1):
        a = band_moment_args(r_inputs, r_config, m, dev)
        e_rk1.append(max(rel(x, y) for x, y in zip(
            fused_band.fused_moment(*a[0], **a[1]),
            fused_band.moment_reference(*a[0], **a[1]))))
    zero()
    R_r, T_r = rt_run(r_model, device=dev, spectral_chunk=N_CHUNK)
    r_launches = read()
    r_want = {k: 0 for k in counted}
    r_want["fused_moment"] = (RADAU_N_SPEC // N_CHUNK) * (r_config.m_scat + 1)
    r_kern = rt_solve(r_inputs, r_config, dev)
    r_plain = rt_solve(r_inputs, dataclasses.replace(
        r_config, fused=False, m_scat=-1, ns_sched=(), ns_inter=6), dev)
    e_r = {k: rel(r_kern[k], r_plain[k]) for k in ("R", "T")}
    e_rref = against_stored("radau")
    print(f"Radau flagship IQU nSpec={RADAU_N_SPEC} (N={r_config.N}, "
          f"solar node weight {r_model.quad.wt_mu[r_model.quad.i_mu0]:.4f}): "
          f"launches {r_launches} (want {r_want}); K1 vs plain per moment "
          + " ".join(f"{e:.2e}" for e in e_rk1) + "; kernel path vs plain "
          + " ".join(f"{k}={e:.2e}" for k, e in e_r.items())
          + "; small scene vs JAX f64 reference " + " ".join(
              f"{k}={e:.2e}" for k, e in e_rref.items()), flush=True)
    if not (r_launches == r_want and all(e <= GATE for e in e_rk1)
            and all(e <= GATE for e in e_r.values())
            and all(e <= GATE for e in e_rref.values())
            and np.isfinite(R_r).all()):
        fail(f"Radau scene: launches {r_launches}, K1 {e_rk1}, path {e_r}, "
             f"stored {e_rref}")

    # 6. Timing: each solve alone (best of 3 after a warm-up), the canopy's
    # K1 a launch.
    chunks = [spectral_slice(inputs, config, c, c + N_CHUNK)
              for c in range(0, CANOPY_N_SPEC, N_CHUNK)]
    canopy_s, canopy_all = best_of(
        lambda: [rt_solve(i, c, dev)["R"] for i, c in chunks])
    ss_s, ss_all = best_of(lambda: rt_solve_ss(inputs, config, dev)["R"])
    # What the chunks' 4-D surface costs to move (f64 host -> f32 card).
    move_s, _ = best_of(lambda: [
        x.to(dtype=torch.float32).to(device=dev)
        for i, _ in chunks for x in (i.surf_r, i.surf_j_m)])
    kw, lamb = _on_device(_pack(cfg_all), dev)
    ex_s, ex_all_t = best_of(lambda: _ss_paths(
        **kw, n_stokes=cfg_all.n_stokes, lambertian_surface=lamb))
    k_ms = cuda_time_ms(lambda: fused_band.fused_moment(*args[0], **args[1]))
    p_ms = cuda_time_ms(
        lambda: fused_band.moment_reference(*args[0], **args[1]), reps=3)
    flops = moment_flops(config, N_CHUNK)
    k1_bytes = moment_bytes(args, k1_out)
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, \
        k1_bytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    for name, value in (("canopy_pts_per_s", CANOPY_N_SPEC / canopy_s),
                        ("ss_pts_per_s", CANOPY_N_SPEC / ss_s),
                        ("exact_ss_pts_per_s", CANOPY_N_SPEC / ex_s),
                        ("canopy_build_s", build_s),
                        ("canopy_k1_ms_a_launch", k_ms)):
        print(f"{name} {value} ({smi})", flush=True)
    print(json.dumps({
        "card": smi, "canopy_pts_per_s": CANOPY_N_SPEC / canopy_s,
        "canopy_build_s": build_s, "canopy_surface_build_s": surface_s,
        "canopy_surface_move_s": move_s, "canopy_solve_s": canopy_s,
        "canopy_solve_all_s": canopy_all,
        "ss_pts_per_s": CANOPY_N_SPEC / ss_s, "ss_solve_all_s": ss_all,
        "exact_ss_pts_per_s": CANOPY_N_SPEC / ex_s,
        "exact_ss_all_s": ex_all_t, "n_spec": CANOPY_N_SPEC,
        "launches": launches, "phase_s": time.perf_counter() - phase_t0,
        "moment_launch_canopy": {
            "n_spec": N_CHUNK, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "bound_share": bound / k_ms, "flops": flops,
            "bytes": k1_bytes, "achieved_tflops": flops / k_ms / 1e9,
            "ndoubl": config.ndoubl}}), flush=True)


def surface_bytes(inputs, config):
    """(host bytes, card bytes) of a band's 4-D surface (surf_r, surf_j_m):
    as ``build_band`` keeps it (f64 on the host) and as it crosses to the
    card, cast there to the solve's dtype."""
    n = inputs.surf_r.numel() + inputs.surf_j_m.numel()
    return (nbytes(inputs.surf_r, inputs.surf_j_m),
            n * np.dtype(config.dtype).itemsize)


def entries_4d_phase(dev, smi):
    """The five other entry points over a spectrally resolved (4-D) canopy
    surface, each at its own chip scene and width (see the module
    docstring, phase 13). Returns {entry: launches}."""
    from vsmartmom_tpu_torch import (default_layout, flagship_model,
                                     rrs_sif_model, rt_run_inelastic,
                                     rt_run_lin, rt_run_ms, rt_run_ms_rrs,
                                     rt_run_stellar)
    from vsmartmom_tpu_torch.core import linearization, multisensor
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    rt_solve_rrs,
                                                    rt_solve_rrs_fused)
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        rt_solve_jvp)
    from vsmartmom_tpu_torch.core.solver import spectral_slice
    from vsmartmom_tpu_torch.flagship import over_canopy, stellar_sif_model
    from vsmartmom_tpu_torch.inelastic.stellar import sol_rrs_setup
    from vsmartmom_tpu_torch.ops import fused_lin
    counted = launch_counted()
    phase_t0 = time.perf_counter()
    keys = ("R", "T", "ieR", "ieT")
    report = {}
    steps = {}
    clock = [time.perf_counter()]

    def step(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now

    def run_counted(fn):
        for c in counted.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counted.items()
                     if c.launches}, time.perf_counter() - t0

    def record(name, model, inputs, config, launches, secs, errs):
        host, card = surface_bytes(inputs, config)
        report[name] = {"n_spec": config.n_spec, "launches": launches,
                        "pts_per_s": config.n_spec / secs, "entry_s": secs,
                        "surf_r": list(inputs.surf_r.shape),
                        "surface_bytes_host": host,
                        "surface_bytes_card": card, "errors": errs}
        print(f"4-D {name}: nSpec={config.n_spec} N={config.N} surf_r "
              f"{tuple(inputs.surf_r.shape)} on {inputs.surf_r.device}, "
              f"surface bytes host {host} (f64) card {card} "
              f"({np.dtype(config.dtype).name}); launches {launches}; "
              f"{config.n_spec / secs:.1f} pts/s ({secs:.2f} s, the build "
              "included); kernel route vs plain " + " ".join(
                  f"{k}={e:.2e}" for k, e in errs.items()) + f" ({smi})",
              flush=True)

    def check_4d(name, inputs):
        if inputs.surf_r.dim() != 4 or inputs.surf_j_m.dim() != 4:
            fail(f"4-D {name}: surf_r {tuple(inputs.surf_r.shape)}")
        spread = float((inputs.surf_r[0, 0] - inputs.surf_r[0, -1]).abs()
                       .max() / inputs.surf_r[0].abs().max())
        if not spread > 1e-3:
            fail(f"4-D {name}: the surface does not vary across the band "
                 f"({spread})")

    # (a) rt_run_lin: the aerosol flagship over the canopy, K2 at P = 7.
    # The entry point's own band build and tangents are kept for the
    # route check (its build_tangent_inputs wrapped for the run), and so
    # is each K2 launch's output on the checked points (its launch
    # wrapped under the counted wrapper, whose count is the one read).
    model = over_canopy(flagship_model(LIN_N_SPEC, aerosol=True), device=dev)
    layout = default_layout(model)
    step("lin scene")
    built, launched = [], []

    def keep_build(*a, **kw):
        built.append(build_tangent_inputs(*a, **kw))
        return built[-1]

    def checked_points(inputs):
        """The LIN_SLICE points from the brightest surface point."""
        a = min(int(inputs.surf_r[0, :, 0, 0].abs().argmax()),
                LIN_N_SPEC - LIN_SLICE)
        return a, a + LIN_SLICE
    k2 = fused_lin._launch_kernel

    def keep_k2(*args):
        comp, dcomp = k2(*args)
        a, b = checked_points(built[0][0])
        launched.append(([x[a:b].clone() for x in comp],
                         [x[:, a:b].clone() for x in dcomp]))
        return comp, dcomp
    linearization.build_tangent_inputs = keep_build
    fused_lin._launch_kernel = keep_k2
    try:
        (R, T, dR, dT), launches, secs = run_counted(
            lambda: rt_run_lin(model, layout=layout, device=dev))
    finally:
        linearization.build_tangent_inputs = build_tangent_inputs
        fused_lin._launch_kernel = k2
    inputs, config, tans = built[0]
    check_4d("rt_run_lin", inputs)
    step("lin entry")
    want = {"fused_moment_multitangent": config.m_scat + 1}
    if launches != want or layout.n_total != 7 or \
            dR.shape != (9, 4, LIN_N_SPEC, 7) or not all(
                np.isfinite(x).all() for x in (R, T, dR, dT)):
        fail(f"4-D rt_run_lin: launches {launches} (want {want}), layout "
             f"{layout.names()}, dR {dR.shape} or not finite")
    # The entry's K2 launches of moments 0..ROUTE_CHECK_M against K2's
    # plain version on the checked points' operands (sixteen plain
    # multitangent jvps took 32.8 s; the surface is the same code at
    # every moment).
    a, b = checked_points(inputs)
    sl_in, sl_full = spectral_slice(inputs, config, a, b)
    sl_tans = [spectral_slice(t, config, a, b)[0] for t in tans]
    refs = [fused_lin.moment_multitangent_reference(
        *fused_lin.multitangent_args(sl_in, sl_tans, sl_full, m, dev))
        for m in range(min(len(launched), ROUTE_CHECK_M + 1))]
    k2_prim, k2_tan, _ = mt_errors(launched[:len(refs)], refs)
    n_checked = len(refs)
    del launched, refs
    step("lin launches check")
    # The routes compared on those points, moments 0..ROUTE_CHECK_M (the
    # plain jvp routes, f32 and f64, are launch-bound: all 16 moments
    # took 92 s of the phase).
    sl_cfg = dataclasses.replace(sl_full,
                                 m_max=min(config.m_max, ROUTE_CHECK_M))
    kern = fused_lin.rt_solve_multitangent(sl_in, sl_tans, sl_cfg, dev)
    plain = rt_solve_jvp(sl_in, sl_tans, dataclasses.replace(
        sl_cfg, fused=False), dev)
    f64 = rt_solve_jvp(sl_in, sl_tans, dataclasses.replace(
        sl_cfg, fused=False, dtype=np.float64), dev)
    names = layout.names()
    errs = {"R": rel(kern[0], plain[0])}
    errs.update({n: rel(kern[2][q], plain[2][q])
                 for q, n in enumerate(names)})
    # A 1% error in the kernel route's height Jacobians must fail their
    # gate.
    control = {n: rel(1.01 * kern[2][q], plain[2][q])
               for q, n in enumerate(names) if n.endswith(HEIGHT_PARAMS)}
    # Each route's dR from an f64 run of the plain route, and each
    # parameter's scale against tau_ref's: a weak parameter's two f32
    # routes part by f32 rounding on the strong ones' scale.
    e64 = {n: (rel(kern[2][q].double(), f64[2][q]),
               rel(plain[2][q].double(), f64[2][q]))
           for q, n in enumerate(names)}
    scale = {n: float(f64[2][q].abs().max() / f64[2][0].abs().max())
             for q, n in enumerate(names)}
    step("lin route check")
    record("rt_run_lin", model, inputs, config, launches, secs, errs)
    print("4-D rt_run_lin dR vs f64 (kernel route, plain f32 route) and "
          "scale / tau_ref's: " + " ".join(
              f"{n}=({x:.2e}, {y:.2e}, {scale[n]:.1e})"
              for n, (x, y) in e64.items()) + "; height dR 1% off "
          + " ".join(f"{n}={e:.2e}" for n, e in control.items())
          + f"; K2's launches of m=0..{n_checked - 1} vs plain K2 on those "
          f"points: primal={k2_prim:.2e} tangents per parameter "
          + " ".join(f"{e:.2e}" for e in k2_tan), flush=True)
    report["rt_run_lin"]["k2_launches_vs_plain"] = {
        "primal": k2_prim, **dict(zip(names, k2_tan))}
    report["rt_run_lin"]["height_control"] = control
    gates = {n: HEIGHT_GATE if n.endswith(HEIGHT_PARAMS) else TAN_GATE
             for n in names}
    if not (errs["R"] <= GATE and all(errs[n] <= gates[n] for n in names)
            and all(x <= max(F64_RATIO * y, TAN_GATE)
                    for x, y in e64.values())
            and all(e > HEIGHT_GATE for e in control.values())
            and k2_prim <= GATE and all(e <= TAN_GATE for e in k2_tan)):
        fail(f"4-D rt_run_lin kernel route vs jvp route: {errs}; vs f64 "
             f"{e64}; control {control}; K2 launches vs plain K2 "
             f"{k2_prim}, {k2_tan}")
    del kern, plain, f64, tans, sl_tans, dR, dT

    # (b) rt_run_ms: the flagship over the canopy, K5; the routes compared
    # on the first quarter of the band.
    model = over_canopy(flagship_model(MS_N_SPEC), device=dev)
    inputs, config = model.build_band(0, device=dev)
    check_4d("rt_run_ms", inputs)
    step("ms scene")
    (uwJ, dwJ), launches, secs = run_counted(
        lambda: rt_run_ms(model, MS_LEVELS, device=dev))
    want = {"fused_doubling": config.m_max + 1}
    if launches != want or not (np.isfinite(uwJ).all()
                                and np.isfinite(dwJ).all()):
        fail(f"4-D rt_run_ms: launches {launches} (want {want}) or not "
             "finite")
    step("ms entry")
    q = MS_N_SPEC // 4
    sl = spectral_slice(inputs, config, 0, q)
    kern = multisensor.rt_solve_ms(*sl, MS_LEVELS, dev)
    plain = multisensor.rt_solve_ms(
        sl[0], dataclasses.replace(sl[1], fused=False), MS_LEVELS, dev)
    errs = {f"{k}[{L}]": rel(kern[k][i], plain[k][i])
            for k in ("uwJ", "dwJ") for i, L in enumerate(MS_LEVELS)}
    errs["entry vs slice"] = rel(uwJ[..., :q], kern["uwJ"].cpu())
    step("ms route check")
    record("rt_run_ms", model, inputs, config, launches, secs, errs)
    if not all(e <= GATE for e in errs.values()):
        fail(f"4-D rt_run_ms kernel route vs LU route: {errs}")
    del kern, plain

    # (c) rt_run_inelastic RRS: the RRS+SIF scene over the canopy, K1 + K3.
    model = over_canopy(rrs_sif_model(RRS_N_SPEC), device=dev)
    inputs, config, *rrs = inelastic_setup(model, device=dev)
    check_4d("rrs", inputs)
    step("rrs scene")
    out, launches, secs = run_counted(lambda: dict(zip(keys, rt_run_inelastic(
        model, mode="RRS", device=dev))))
    n_m = config.m_max + 1
    if set(launches) != {"fused_moment", "fused_moment_rrs",
                         "rrs_diagonal"} or \
            launches["fused_moment"] != n_m or not all(
                np.isfinite(v).all() for v in out.values()):
        fail(f"4-D RRS: launches {launches} or not finite")
    # The routes compared on moments 0..2 (the canopy's surface takes 16;
    # the plain Raman solve is launch-bound, a moment ~2-4 s here).
    cut = dataclasses.replace(config, m_max=min(config.m_max, ROUTE_CHECK_M))
    fused = rt_solve_rrs_fused(inputs, cut, *rrs, device=dev,
                               ie_fullres=True)
    coarse = rt_solve_rrs_fused(inputs, cut, *rrs, device=dev)
    plain = rt_solve_rrs(inputs, dataclasses.replace(cut, fused=False),
                         *rrs, device=dev)
    errs = {k: rel(fused[k], plain[k]) for k in keys}
    errs["ieR coarse"] = rel(coarse["ieR"], plain["ieR"])
    step("rrs entry and routes")
    record("rrs", model, inputs, config, launches, secs, errs)
    if not (all(errs[k] <= GATE for k in keys)
            and errs["ieR coarse"] <= IE_GATE):
        fail(f"4-D RRS kernel route vs plain: {errs}")
    del fused, coarse, plain

    # (d) rt_run_stellar sol_RRS over the canopy, K1 + K3 (full ie).
    model = over_canopy(stellar_sif_model(), device=dev)
    inputs, config, *st = sol_rrs_setup(model, device=dev)
    check_4d("stellar", inputs)
    step("stellar scene")
    out, launches, secs = run_counted(lambda: dict(zip(keys, rt_run_stellar(
        model, device=dev))))
    if launches.get("fused_moment") != config.m_max + 1 or \
            not launches.get("fused_moment_rrs") or not all(
                np.isfinite(v).all() for v in out.values()):
        fail(f"4-D stellar: launches {launches} or not finite")
    cut = dataclasses.replace(config, m_max=min(config.m_max, ROUTE_CHECK_M))
    fused = rt_solve_rrs_fused(inputs, cut, *st, device=dev, ie_fullres=True)
    plain = rt_solve_rrs(inputs, dataclasses.replace(cut, fused=False), *st,
                         device=dev)
    errs = {k: rel(fused[k], plain[k]) for k in keys}
    step("stellar entry and routes")
    record("stellar", model, inputs, config, launches, secs, errs)
    if not all(e <= GATE for e in errs.values()):
        fail(f"4-D stellar kernel route vs plain: {errs}")
    del fused, plain

    # (e) rt_run_ms_rrs: the MS bench scene over the canopy, plain torch.
    model = over_canopy(rrs_sif_model(MS_RRS_N_SPEC), device=dev)
    inputs, config, *rrs = inelastic_setup(model, device=dev)
    check_4d("ms_rrs", inputs)
    step("ms_rrs scene")
    out, launches, secs = run_counted(lambda: dict(zip(
        ("uwJ", "dwJ", "ieuwJ", "iedwJ"), rt_run_ms_rrs(
            model, MS_RRS_LEVELS, mode="RRS", device=dev))))
    if launches or not all(np.isfinite(v).all() for v in out.values()):
        fail(f"4-D MS-RRS: launches {launches} or not finite")
    cut = dataclasses.replace(config, fused=False,
                              m_max=min(config.m_max, ROUTE_CHECK_M))
    ms = multisensor.rt_solve_ms_rrs(inputs, cut, (0,), *rrs, dev)
    plain = rt_solve_rrs(inputs, cut, *rrs, device=dev)
    errs = {"uwJ[0]-R": rel(ms["uwJ"][0], plain["R"]),
            "ieuwJ[0]-ieR": rel(ms["ieuwJ"][0], plain["ieR"])}
    step("ms_rrs entry and routes")
    record("ms_rrs", model, inputs, config, launches, secs, errs)
    if not all(e <= GATE for e in errs.values()):
        fail(f"4-D MS-RRS level 0 vs the plain RRS solve: {errs}")
    print(json.dumps({"card": smi, "entries_4d": report, "steps_s": steps,
                      "phase_s": time.perf_counter() - phase_t0}),
          flush=True)
    return {k: v["launches"] for k, v in report.items()}


#: The 4-D route checks of the Jacobian and the Raman entry points run
#: moments 0..ROUTE_CHECK_M (the canopy surface's 16 moments through the
#: launch-bound plain routes would take minutes; the surface step is the
#: same code at every moment).
ROUTE_CHECK_M = 2
#: The sharded runs' widths: the flagship through K1, and the RRS+SIF scene
#: through K1 + K3, wide enough that each rank's halo (max|shift| = 389
#: points at 1024) leaves it a part of the band.
SHARD_N_SPEC, SHARD_RRS_N_SPEC, SHARD_RANKS = 4096, 1024, 2


def _shard_rank(rank, world, n_spec, rrs_n_spec):
    """A gloo rank sharing the card, one spawn for both sharded runs:
    (``_shard_flagship``, ``_shard_rrs``)."""
    return _shard_flagship(n_spec), _shard_rrs(rrs_n_spec)


def _shard_flagship(n_spec):
    """This rank's slice of the flagship through ``rt_solve`` (K1), the
    five outputs gathered on the host. Returns (outputs, K1 launches, its
    points)."""
    from vsmartmom_tpu_torch import flagship_model
    from vsmartmom_tpu_torch.core.solver import rt_solve
    from vsmartmom_tpu_torch.ops import fused_band
    from vsmartmom_tpu_torch.parallel.sharding import (
        gather_outputs, numpy_outputs, shard_inputs, spectral_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = spectral_mesh()
    inputs, config = shard_inputs(*flagship_model(n_spec).build_band(
        0, device=dev), mesh)
    fused_band.fused_moment.launches = 0
    out = rt_solve(inputs, config, dev)
    torch.cuda.synchronize()
    launches = fused_band.fused_moment.launches
    out = gather_outputs({k: out[k] for k in ("R", "T", "hdr", "bhr_uw",
                                               "bhr_dw")}, mesh)
    return numpy_outputs(out), launches, config.n_spec


def _shard_rrs(n_spec):
    """This rank's slice of the RRS+SIF scene with its halo through K1 +
    K3, trimmed and gathered on the host. Returns (outputs, launches,
    (points solved, own start, own stop))."""
    from vsmartmom_tpu_torch import rrs_sif_model
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    solve_rrs_route)
    from vsmartmom_tpu_torch.parallel.sharding import (
        gather_outputs, numpy_outputs, shard_raman, spectral_mesh, trim)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = spectral_mesh()
    model = rrs_sif_model(n_spec)
    inputs, config, *rrs = inelastic_setup(model, device=dev)
    inputs, config, rrs, keep = shard_raman(inputs, config, rrs, mesh)
    counted = launch_counted()
    for c in counted.values():
        c.launches = 0
    out = solve_rrs_route(model, inputs, config, rrs, dev)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counted.items() if c.launches}
    out = gather_outputs(trim(out, keep), mesh)
    return numpy_outputs(out), launches, (config.n_spec, keep.start,
                                          keep.stop)


def sharding_phase(dev, smi):
    """Spectral sharding on the card (see the module docstring, phase 14).
    Returns {run: launches per rank}."""
    from vsmartmom_tpu_torch import flagship_model, rrs_sif_model
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    solve_rrs_route)
    from vsmartmom_tpu_torch.core.solver import rt_solve
    from vsmartmom_tpu_torch.flagship import dryrun_multichip
    from vsmartmom_tpu_torch.ops import fused_band
    from vsmartmom_tpu_torch.parallel.sharding import run_ranks
    phase_t0 = time.perf_counter()
    report = {}

    # (a) The dry run: one NCCL rank on the card.
    t0 = time.perf_counter()
    R = dryrun_multichip(1)
    report["dryrun_s"] = time.perf_counter() - t0
    if R.shape != (9, 4, 8) or not np.isfinite(R).all():
        fail(f"dryrun_multichip(1): R {R.shape}")

    # Two gloo ranks sharing the card, spawned once for (b) and (c); the
    # unsharded runs on the card first.
    model = flagship_model(SHARD_N_SPEC)
    inputs, config = model.build_band(0, device=dev)
    fused_band.fused_moment.launches = 0
    whole = rt_solve(inputs, config, dev)
    torch.cuda.synchronize()
    whole_launches = fused_band.fused_moment.launches
    rrs_model = rrs_sif_model(SHARD_RRS_N_SPEC)
    rrs_inputs, rrs_config, *rrs = inelastic_setup(rrs_model, device=dev)
    rrs_whole = solve_rrs_route(rrs_model, rrs_inputs, rrs_config, rrs, dev)
    t0 = time.perf_counter()
    both = run_ranks(_shard_rank, SHARD_RANKS, SHARD_N_SPEC,
                     SHARD_RRS_N_SPEC, backend="gloo", timeout=600)
    report["ranks_s"] = time.perf_counter() - t0

    # (b) The flagship through K1.
    ranks = [r[0] for r in both]
    dist = {k: max(rel(r[0][k], whole[k].cpu()) for r in ranks)
            for k in ("R", "T", "hdr", "bhr_uw", "bhr_dw")}
    bits = all(np.array_equal(r[0][k], whole[k].cpu().numpy())
               for r in ranks for k in dist)
    report["flagship"] = {"launches": [r[1] for r in ranks],
                          "points": [r[2] for r in ranks],
                          "unsharded_launches": whole_launches,
                          "distance": dist, "bit_equal": bits}
    print(f"sharded flagship ({SHARD_RANKS} gloo ranks on one card, nSpec="
          f"{SHARD_N_SPEC}): K1 launches per rank "
          f"{[r[1] for r in ranks]} (unsharded {whole_launches}), points "
          f"{[r[2] for r in ranks]}; gathered vs unsharded " + " ".join(
              f"{k}={e:.2e}" for k, e in dist.items())
          + f", bit-equal {bits} (both runs' ranks {report['ranks_s']:.1f} "
          "s)", flush=True)
    if not (all(e <= GATE for e in dist.values()) and all(
            r[1] == config.m_scat + 1 for r in ranks)):
        fail(f"sharded flagship: {report['flagship']}")
    del whole

    # (c) The RRS+SIF scene, K1 + K3, with the halo.
    ranks, whole, config = [r[1] for r in both], rrs_whole, rrs_config
    keys = ("R", "T", "ieR", "ieT")
    dist = {k: max(rel(r[0][k], whole[k].cpu()) for r in ranks)
            for k in keys}
    bits = all(np.array_equal(r[0][k], whole[k].cpu().numpy())
               for r in ranks for k in keys)
    halo = max(abs(int(x)) for x in rrs[0])
    report["rrs"] = {"launches": [r[1] for r in ranks],
                     "slices": [r[2] for r in ranks], "halo": halo,
                     "distance": dist, "bit_equal": bits}
    print(f"sharded RRS+SIF ({SHARD_RANKS} gloo ranks on one card, nSpec="
          f"{SHARD_RRS_N_SPEC}, {len(rrs[0])} shifts, halo {halo} points): "
          f"per rank (points solved, own start, stop) "
          f"{[r[2] for r in ranks]}, launches {[r[1] for r in ranks]}; "
          "gathered vs unsharded " + " ".join(
              f"{k}={e:.2e}" for k, e in dist.items())
          + f", bit-equal {bits}", flush=True)
    if not (all(e <= GATE for e in dist.values()) and all(
            r[1].get("fused_moment") == config.m_max + 1
            and r[1].get("fused_moment_rrs") for r in ranks)):
        fail(f"sharded RRS: {report['rrs']}")
    print(json.dumps({"card": smi, "sharding": report,
                      "phase_s": time.perf_counter() - phase_t0}),
          flush=True)
    return report


#: The wide scenes (65 <= N <= 128): the IQUV Radau flagship (N = 68,
#: ``rt_run_full``), the flagship at nstreams 16 (N = 84, ``rt_run`` in
#: chunks of N_CHUNK) and its aerosol Jacobian (N = 84, P = 8), each
#: kernel route against the plain route on WIDE_SLICE points, moments
#: 0..ROUTE_CHECK_M. The Jacobian keeps every moment to m_scat = 31 (the
#: Cox-Munk ocean at nstreams 16): 32 K2 launches, so it runs 128 points
#: (1024 clusters of 4 blocks a launch, ~31 waves on 132 SMs), the work
#: of 16 launches at 256.
WIDE_RADAU_N_SPEC, WIDE_N_SPEC, WIDE_LIN_N_SPEC = 1024, 4096, 128
WIDE_SLICE = 64
#: The launch checks' (N, K), each on 64 points of 3 layers
#: (``flagship.wide_check_model``): K1 across its single block and its
#: clusters; K2 across its narrow and wide plans, K1' (K = 2) at 84.
WIDE_K1_CHECKS = ((52, 1), (64, 1), (65, 1), (68, 1), (84, 1), (104, 1),
                  (128, 1), (84, 2), (128, 2))
WIDE_K2_CHECKS = ((52, 1), (53, 1), (84, 1), (128, 1), (84, 2))
#: The widths whose launches are timed.
WIDE_TIMED = (84, 128)


def wide_phase(dev, smi):
    """Wide-stream scenes through K1's and K2's cluster kernels (see the
    module docstring, phase 15). Returns the kernels-line entries of the
    two cluster kernels (K1's and K2's wide instances)."""
    import warnings

    from vsmartmom_tpu_torch import (default_layout, flagship_model, rt_run,
                                     rt_run_full, rt_run_lin)
    from vsmartmom_tpu_torch.core import linearization, solver
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        rt_solve_jvp)
    from vsmartmom_tpu_torch.core.solver import (band_moment_args, rt_solve,
                                                 spectral_slice)
    from vsmartmom_tpu_torch.flagship import radau_model, wide_check_model
    from vsmartmom_tpu_torch.ops import fused_band, fused_lin
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV
    counted = launch_counted()
    phase_t0 = time.perf_counter()
    steps = {}
    clock = [time.perf_counter()]

    def step(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now

    def run_counted(fn):
        """fn() with every launch counter set to 0 just before and read
        just after, and any width warning caught: (out, launches, s)."""
        for c in counted.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        wide = [str(w.message) for w in caught
                if "takes N <=" in str(w.message)]
        if wide:
            fail(f"a wide scene took a plain route: {wide}")
        return out, {k: c.launches for k, c in counted.items()
                     if c.launches}, secs

    def bound(flops, n_bytes):
        t_ops = flops / FP32_PEAK_FLOPS * 1e3
        t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"

    # (a) K1's launch checks: each moment up to m_scat against its plain
    # version, and the f64 witness.
    timed = {}
    k1_abs = 0.0
    for N, K in WIDE_K1_CHECKS:
        inputs, config = wide_check_model(N, thermal=K == 2).build_band(
            0, device=dev)
        if not (config.fused and config.N == N and config.n_sources == K):
            fail(f"wide K1 check N={N} K={K}: fused={config.fused} "
                 f"N={config.N} K={config.n_sources}")
        plan = fused_band.band_cluster_info(N, K)
        host = fused_band.band_cluster_plan(N, K)
        if any(plan[k] != host[k] for k in ("cluster", "band", "threads",
                                            "smem")) or plan["resident"] < 1:
            fail(f"wide K1 plan N={N} K={K}: C {plan}, host {host}")
        errs, e64 = [], []
        for m in range(config.m_scat + 1):
            args, kw = band_moment_args(inputs, config, m, dev)
            out = fused_band.fused_moment(*args, **kw)
            torch.cuda.synchronize()
            ref = fused_band.moment_reference(*args, **kw)
            errs.append(max(rel(a, b) for a, b in zip(out, ref)))
            if plan["cluster"] > 1:
                k1_abs = max([k1_abs] + [float((a - b).abs().max())
                                         for a, b in zip(out, ref)])
            e64.append(band_f64_errors(args, kw, out, ref))
            if m == 0 and K == 1 and N in WIDE_TIMED:
                timed[("K1", N)] = (args, kw, config, out, plan)
        print(f"wide K1 N={N} K={K} (64 points, {config.nz} layers, "
              f"ndoubl {config.ndoubl}): plan {json.dumps(plan)}; vs plain "
              f"m=0..{config.m_scat} " + " ".join(f"{e:.2e}" for e in errs)
              + "; vs f64 plain: kernel "
              f"{max(e[0] for e in e64):.2e}, f32 plain "
              f"{max(e[1] for e in e64):.2e}", flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs) or not all(
                k <= F64_RATIO * p for k, p in e64):
            fail(f"wide K1 N={N} K={K}: vs plain {errs}, vs f64 {e64}")
    step("K1 launch checks")

    # (b) K2's launch checks at P = 8: moments 0 and 1 against its plain
    # version (forward-mode AD of the plain body), and the primal's f64
    # witness. K1' (K = 2) reuses the K = 1 scene's tangents: the layout
    # has no temperature parameter.
    k2_abs, tangents_of = 0.0, {}
    for N, K in WIDE_K2_CHECKS:
        model = wide_check_model(N, aerosol=True, thermal=K == 2)
        if K == 1:
            inputs, config, tans = build_tangent_inputs(
                model, 0, default_layout(model), device=dev)
            tangents_of[N] = tans
        else:
            inputs, config = model.build_band(0, device=dev)
            tans = tangents_of[N]
        P = len(tans)
        if not (config.fused and config.N == N and config.n_sources == K
                and P == 8):
            fail(f"wide K2 check N={N} K={K}: fused={config.fused} "
                 f"N={config.N} K={config.n_sources} P={P}")
        plan = fused_lin.mt_plan(N, K, P)
        info = fused_lin.mt_launch_info(N, K, P)
        if any(info[k] != plan[k] for k in ("cluster", "groups", "threads",
                                            "smem", "tiles")) \
                or info["max_clusters"] < 1:
            fail(f"wide K2 plan N={N} K={K}: C {info}, host {plan}")
        outs, refs, e64 = [], [], []
        for m in (0, 1):
            args = fused_lin.multitangent_args(inputs, tans, config, m, dev)
            outs.append(fused_lin.fused_moment_multitangent(*args))
            torch.cuda.synchronize()
            refs.append(fused_lin.moment_multitangent_reference(*args))
            e64.append(primal_f64_errors(args, outs[-1][0], refs[-1][0]))
            if m == 0 and K == 1 and N in WIDE_TIMED:
                timed[("K2", N)] = (args, config, outs[-1], info)
        prim, tan, abs_err = mt_errors(outs, refs)
        if plan["wide"]:
            k2_abs = max(k2_abs, abs_err)
        del outs, refs
        print(f"wide K2 N={N} K={K} P={P} (64 points, {config.nz} layers, "
              f"ndoubl {config.ndoubl}): plan {json.dumps(info)} wide="
              f"{plan['wide']}; vs plain m=0,1: primal={prim:.2e} tangents "
              "per parameter " + " ".join(f"{e:.2e}" for e in tan)
              + f"; primal vs f64 plain: kernel "
              f"{max(e[0] for e in e64):.2e}, f32 plain "
              f"{max(e[1] for e in e64):.2e}", flush=True)
        if not (np.isfinite(prim) and prim <= GATE and all(
                np.isfinite(e) and e <= TAN_GATE for e in tan) and all(
                k <= F64_RATIO * p for k, p in e64)):
            fail(f"wide K2 N={N} K={K}: primal {prim}, tangents {tan}, "
                 f"vs f64 {e64}")
    del tangents_of
    step("K2 launch checks")

    # (c) Per launch at N = 84 and 128 on the check shapes (64 points, 3
    # layers; printed, not the kernels line's, which times the scenes'
    # own launches below): ms, the plain version's, the bound and the
    # cluster size.
    launch = {}
    for N in WIDE_TIMED:
        args, kw, config, out, plan = timed[("K1", N)]
        k_ms = cuda_time_ms(lambda: fused_band.fused_moment(*args, **kw))
        p_ms = cuda_time_ms(lambda: fused_band.moment_reference(*args, **kw),
                            reps=3)
        flops = moment_flops(config, 64)
        b_ms, b_by = bound(flops, moment_bytes((args, kw), out))
        launch[("K1", N)] = {"kernel_ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "bound_share": b_ms / k_ms, "flops": flops,
                             "cluster": plan["cluster"],
                             "band": plan["band"],
                             "resident": plan["resident"]}
        args, config, out, info = timed[("K2", N)]
        P = args[1].Z_pp.shape[0]
        k_ms = cuda_time_ms(lambda: fused_lin._launch_kernel(*args), reps=2)
        p_ms = cuda_time_ms(
            lambda: fused_lin.moment_multitangent_reference(*args), reps=1)
        primal = moment_flops(config, 64)
        flops = (1 + 2 * P) * primal
        b_ms, b_by = bound(flops, nbytes(*args[0], *args[1], *out[0],
                                         *out[1]))
        launch[("K2", N)] = {"kernel_ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "bound_share": b_ms / k_ms, "flops": flops,
                             "flops_kernel": 3 * P * primal,
                             "cluster": info["cluster"],
                             "resident_clusters": info["max_clusters"]}
    for (k, N), v in launch.items():
        print(f"wide {k} N={N} a launch (64 points, 3 layers): "
              f"{v['kernel_ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, "
              f"bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
              f"{100 * v['bound_share']:.1f}% of it, cluster "
              f"{v['cluster']} ({smi})", flush=True)
    del timed
    step("launch timing")

    # (d) The IQUV Radau flagship (N = 68: K1's single block).
    report = {}
    model = radau_model(WIDE_RADAU_N_SPEC, polarization=STOKES_IQUV)
    inputs, config = model.build_band(0, device=dev)
    if not (config.fused and config.N == 68):
        fail(f"IQUV Radau scene: fused={config.fused} N={config.N}")
    with timed_calls(solver, "rt_solve") as solve_times:
        out, launches, secs = run_counted(
            lambda: rt_run_full(model, device=dev))
    want = {"fused_moment": config.m_scat + 1}
    if launches != want or not all(np.isfinite(out[k]).all()
                                   for k in ("R", "T", "hdr")):
        fail(f"IQUV Radau rt_run_full: launches {launches} (want {want}) "
             "or not finite")
    sl = spectral_slice(inputs, config, 0, WIDE_SLICE)
    cut = dataclasses.replace(sl[1], m_max=min(config.m_max, ROUTE_CHECK_M))
    kern = rt_solve(sl[0], cut, dev)
    plain = rt_solve(sl[0], dataclasses.replace(
        cut, fused=False, m_scat=-1, ns_sched=(), ns_inter=6), dev)
    errs = {k: rel(kern[k], plain[k]) for k in ("R", "T")}
    solve_s = sum(solve_times)
    report["radau_iquv"] = {"N": config.N, "n_spec": WIDE_RADAU_N_SPEC,
                            "launches": launches,
                            "pts_per_s": WIDE_RADAU_N_SPEC / solve_s,
                            "solve_s": solve_s, "entry_s": secs,
                            "errors": errs}
    step("IQUV Radau scene")

    # (e) The wide flagship (N = 84: K1's clusters of 2).
    model = flagship_model(n_spec=WIDE_N_SPEC, nstreams=16)
    inputs, config = model.build_band(0, device=dev)
    if not (config.fused and config.N == 84):
        fail(f"wide flagship: fused={config.fused} N={config.N}")
    with timed_calls(solver, "rt_solve") as solve_times:
        (R, T), launches, secs = run_counted(
            lambda: rt_run(model, device=dev, spectral_chunk=N_CHUNK))
    n_launch = (WIDE_N_SPEC // N_CHUNK) * (config.m_scat + 1)
    want = {"fused_moment": n_launch, "fused_moment_cluster": n_launch}
    if launches != want or R.shape != (9, 4, WIDE_N_SPEC) or not (
            np.isfinite(R).all() and np.isfinite(T).all()):
        fail(f"wide flagship rt_run: launches {launches} (want {want}), "
             f"R {R.shape} or not finite")
    k1_launches = launches["fused_moment_cluster"]
    # K1 on moment 0 of the first chunk, the shape the run launched: the
    # kernels line's times and bound.
    args, kw = band_moment_args(
        *spectral_slice(inputs, config, 0, N_CHUNK), 0, dev)
    out = fused_band.fused_moment(*args, **kw)
    ref = fused_band.moment_reference(*args, **kw)
    k1_abs = max([k1_abs] + [float((a - b).abs().max())
                             for a, b in zip(out, ref)])
    k_ms = cuda_time_ms(lambda: fused_band.fused_moment(*args, **kw))
    p_ms = cuda_time_ms(lambda: fused_band.moment_reference(*args, **kw),
                        reps=2)
    flops = moment_flops(config, N_CHUNK)
    b_ms, b_by = bound(flops, moment_bytes((args, kw), out))
    k1_main = {"n_spec": N_CHUNK, "kernel_ms": k_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / k_ms, "flops": flops,
               "vs_plain": max(rel(a, b) for a, b in zip(out, ref))}
    del args, kw, out, ref
    sl = spectral_slice(inputs, config, 0, WIDE_SLICE)
    cut = dataclasses.replace(sl[1], m_max=min(config.m_max, ROUTE_CHECK_M))
    kern = rt_solve(sl[0], cut, dev)
    plain = rt_solve(sl[0], dataclasses.replace(
        cut, fused=False, m_scat=-1, ns_sched=(), ns_inter=6), dev)
    errs = {k: rel(kern[k], plain[k]) for k in ("R", "T")}
    solve_s = sum(solve_times)
    report["flagship_84"] = {"N": config.N, "n_spec": WIDE_N_SPEC,
                             "launches": launches,
                             "pts_per_s": WIDE_N_SPEC / solve_s,
                             "entry_s": secs, "errors": errs,
                             "solve_s": solve_s}
    step("wide flagship")

    # (f) The wide aerosol Jacobian (N = 84, P = 8: K2's wide plan). The
    # entry's own build and tangents are kept for the route check.
    model = flagship_model(n_spec=WIDE_LIN_N_SPEC, nstreams=16,
                           aerosol=True)
    layout = default_layout(model)
    built = []

    def keep_build(*a, **kw):
        built.append(build_tangent_inputs(*a, **kw))
        return built[-1]
    linearization.build_tangent_inputs = keep_build
    try:
        with timed_calls(fused_lin, "rt_solve_multitangent") as solve_times:
            (R, T, dR, dT), launches, secs = run_counted(
                lambda: rt_run_lin(model, layout=layout, device=dev))
    finally:
        linearization.build_tangent_inputs = build_tangent_inputs
    inputs, config, tans = built[0]
    P = len(tans)
    want = {"fused_moment_multitangent": config.m_scat + 1,
            "fused_moment_multitangent_wide": config.m_scat + 1}
    if launches != want or config.N != 84 or P != 8 or \
            dR.shape != (9, 4, WIDE_LIN_N_SPEC, P) or not all(
                np.isfinite(x).all() for x in (R, T, dR, dT)):
        fail(f"wide rt_run_lin: launches {launches} (want {want}), N "
             f"{config.N}, P {P}, dR {dR.shape} or not finite")
    k2_launches = launches["fused_moment_multitangent_wide"]
    sl_in, sl_cfg = spectral_slice(inputs, config, 0, 8)
    sl_tans = [spectral_slice(t, config, 0, 8)[0] for t in tans]
    cut = dataclasses.replace(sl_cfg, m_max=min(config.m_max, ROUTE_CHECK_M))
    kern = fused_lin.rt_solve_multitangent(sl_in, sl_tans, cut, dev)
    plain = rt_solve_jvp(sl_in, sl_tans, dataclasses.replace(cut, fused=False),
                         dev)
    names = layout.names()
    errs = {"R": rel(kern[0], plain[0])}
    errs.update({n: rel(kern[2][q], plain[2][q])
                 for q, n in enumerate(names)})
    control = {n: rel(1.01 * kern[2][q], plain[2][q])
               for q, n in enumerate(names) if n.endswith(HEIGHT_PARAMS)}
    gates = {n: HEIGHT_GATE if n.endswith(HEIGHT_PARAMS) else TAN_GATE
             for n in names}
    if len(solve_times) != 1:
        fail(f"wide rt_run_lin made {len(solve_times)} multitangent solves")
    # The run's high moments (Cox-Munk keeps every moment to m_scat) on
    # those 8 points, K2 against its plain version: the primal within
    # GATE, each parameter's tangents within TAN_GATE, but the aerosol
    # height's, whose f32 tangents at these moments are too weak to
    # hold 2e-4 between two f32 routes (ROADMAP §3), by the f64 witness:
    # the kernel within F64_RATIO of the f32 plain version's distance
    # from an f64 run.
    high = sorted({config.m_scat // 2, config.m_scat})
    high_args, outs, refs = [], [], []
    for m in high:
        high_args.append(fused_lin.multitangent_args(sl_in, sl_tans, sl_cfg,
                                                     m, dev))
        outs.append(fused_lin.fused_moment_multitangent(*high_args[-1]))
        refs.append(fused_lin.moment_multitangent_reference(*high_args[-1]))
    high_prim, high_tan, abs_err = mt_errors(outs, refs)
    high_f64 = tangent_f64_errors(high_args, outs, refs)
    k2_abs = max(k2_abs, abs_err)
    print(f"wide aerosol Jacobian, K2 vs plain at m={high} (8 points): "
          f"primal={high_prim:.2e} tangents per parameter "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(layout.names(), high_tan))
          + "; tangents vs f64 plain (kernel, f32 plain) " + " ".join(
              f"{n}=({k:.2e}, {p:.2e})"
              for n, (k, p) in zip(layout.names(), high_f64)), flush=True)
    high_ok = [np.isfinite(e) and (
        k <= F64_RATIO * p if n.endswith(HEIGHT_PARAMS) else e <= TAN_GATE)
        for n, e, (k, p) in zip(layout.names(), high_tan, high_f64)]
    if not (np.isfinite(high_prim) and high_prim <= GATE and all(high_ok)):
        fail(f"wide K2 at m={high}: primal {high_prim}, tangents "
             f"{high_tan}, vs f64 {high_f64}")
    del high_args
    # K2 on moment 0 of the run's own operands (128 points, P = 8): the
    # kernels line's times and bound. One call each (seconds a call; both
    # codes ran above).
    args = fused_lin.multitangent_args(inputs, tans, config, 0, dev)
    out, k_ms = timed_once(lambda: fused_lin._launch_kernel(*args))
    ref, p_ms = timed_once(
        lambda: fused_lin.moment_multitangent_reference(*args))
    prim, tan, abs_err = mt_errors([out], [ref])
    k2_abs = max(k2_abs, abs_err)
    primal = moment_flops(config, WIDE_LIN_N_SPEC)
    flops = (1 + 2 * P) * primal
    b_ms, b_by = bound(flops, nbytes(*args[0], *args[1], *out[0], *out[1]))
    k2_main = {"n_spec": WIDE_LIN_N_SPEC, "kernel_ms": k_ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / k_ms, "flops": flops,
               "flops_kernel": 3 * P * primal, "vs_plain": [prim, tan]}
    if not (prim <= GATE and all(e <= TAN_GATE for n, e in zip(
            layout.names(), tan) if not n.endswith(HEIGHT_PARAMS))):
        fail(f"wide K2 at the Jacobian's moment 0: primal {prim}, "
             f"tangents {tan}")
    del args, out, ref, outs, refs
    report["aerosol_jacobian_84"] = {
        "N": config.N, "n_spec": WIDE_LIN_N_SPEC, "n_params": P,
        "launches": launches, "pts_per_s": WIDE_LIN_N_SPEC / solve_times[0],
        "solve_s": solve_times[0], "entry_s": secs, "errors": errs,
        "height_control": control,
        "ms_a_launch": 1e3 * solve_times[0] / (config.m_scat + 1),
        "ndoubl": config.ndoubl, "m_scat": config.m_scat}
    del kern, plain, tans, sl_tans, dR, dT
    step("wide aerosol Jacobian")
    for name, r in report.items():
        print(f"wide scene {name}: N={r['N']} nSpec={r['n_spec']} launches "
              f"{r['launches']}; {r['pts_per_s']:.1f} pts/s; kernel route "
              "vs plain route (m=0..2) " + " ".join(
                  f"{k}={e:.2e}" for k, e in r["errors"].items())
              + f" ({smi})", flush=True)
    print("wide aerosol Jacobian: height dR 1% off " + " ".join(
        f"{n}={e:.2e}" for n, e in control.items()), flush=True)
    ok = all(e <= GATE for r in ("radau_iquv", "flagship_84")
             for e in report[r]["errors"].values())
    ok = ok and errs["R"] <= GATE and all(errs[n] <= gates[n] for n in names)
    if not (ok and all(e > HEIGHT_GATE for e in control.values())):
        fail(f"wide scenes, kernel route vs plain route: {report}")
    for name, v in (("K1 on the wide flagship", k1_main),
                    ("K2 on the wide aerosol Jacobian", k2_main)):
        print(f"{name} (N=84, moment 0, {v['n_spec']} points): "
              f"{v['kernel_ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, "
              f"bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
              f"{100 * v['bound_share']:.1f}% of it ({smi})", flush=True)
    print(json.dumps({"card": smi, "wide": {
        "launch": {f"{k} N={N}": v for (k, N), v in launch.items()},
        "main_path": {"K1": k1_main, "K2": k2_main},
        "scenes": report}, "steps_s": steps,
        "phase_s": time.perf_counter() - phase_t0}), flush=True)
    k1, k2 = k1_main, k2_main
    return [{"name": "fused_moment[cluster]", "route": "cuda",
             "source": "vsmartmom_tpu_torch/csrc/cluster_band.cuh",
             "replaces": "vsmartmom_tpu/ops/fused_band.py:469",
             "launches": k1_launches, "max_abs_err": k1_abs,
             "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
             "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
             "library_ms": None},
            {"name": "fused_moment_multitangent[wide]", "route": "cuda",
             "source": "vsmartmom_tpu_torch/csrc/cluster_band.cuh",
             "replaces": "vsmartmom_tpu/ops/fused_lin.py:214",
             "launches": k2_launches, "max_abs_err": k2_abs,
             "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"],
             "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
             "library_ms": None}]


def moment_bytes(args, out):
    """Bytes one launch must move: its operands read once (the plain prep's
    compact row tables) and the composite written once."""
    from vsmartmom_tpu_torch.ops.fused_band import band_operands
    ops = band_operands(*args[0], **{k: v for k, v in args[1].items()
                                     if k not in ("ns_sched", "ns_inter")})
    return sum(x.numel() * x.element_size() for x in (*ops, *out))


def main():
    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("CUDA is not available: the chip smoke test runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False    # exact f32 products
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")

    from vsmartmom_tpu_torch import (flagship_model, rrs_sif_model, rt_run,
                                     rt_run_inelastic)
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    rrs_moment_args,
                                                    rt_solve_rrs,
                                                    rt_solve_rrs_fused)
    from vsmartmom_tpu_torch.core.solver import (band_moment_args, rt_solve,
                                                 spectral_slice)
    from vsmartmom_tpu_torch.flagship import lin_ref_model, rrs_ref_model
    from vsmartmom_tpu_torch.ops import (cuda_build, fused_band, fused_lin,
                                         fused_rrs)
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I

    # ---- 1. setup: build every kernel (one nvcc per source, together) ----
    sources = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, log) in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            # probe_dots' 26 kernels are reported case by case (probes).
            if ("wgmma" in line or "Performance" in line or (
                    name != "probe_dots"
                    and ("registers" in line or "spill" in line))):
                print(f"  {name}: {line.strip()}")

    # ---- 2. kernel vs plain at the main path's shapes ----
    model = flagship_model(n_spec=N_SPEC_TOTAL, nstreams=8)
    inputs, config = model.build_band(0, device=dev)
    if not config.fused:
        fail("the flagship f32 model on CUDA did not pick the band kernel")
    print(f"config: N={config.N} nz={config.nz} ndoubl={config.ndoubl} "
          f"ns_sched={config.ns_sched} ns_inter={config.ns_inter} "
          f"m_scat={config.m_scat} m_max={config.m_max}", flush=True)
    chunk0 = spectral_slice(inputs, config, 0, N_CHUNK)
    names = ("R_mp", "R_pm", "T_pp", "T_mm", "J0_p", "J0_m")
    max_abs_err = 0.0
    moment_args = []
    lib = cuda_build.load("fused_band")
    lib.vsm_fused_moment_smem_bytes.restype = ctypes.c_size_t
    k1_plan = {"threads": lib.vsm_fused_moment_threads(),
               "smem_bytes": {K: lib.vsm_fused_moment_smem_bytes(config.N, K)
                              for K in (1, 2)},
               "blocks_per_sm": {
                   K: lib.vsm_fused_moment_blocks_per_sm(config.N, K)
                   for K in (1, 2)}}
    print(f"K1 launch at N={config.N}: {json.dumps(k1_plan)}", flush=True)
    k1_f64 = []
    for m in range(config.m_scat + 1):
        args = band_moment_args(*chunk0, m, dev)
        moment_args.append(args)
        out = fused_band.fused_moment(*args[0], **args[1])
        torch.cuda.synchronize()
        ref = fused_band.moment_reference(*args[0], **args[1])
        errs = {n: rel(a, b) for n, a, b in zip(names, out, ref)}
        max_abs_err = max([max_abs_err] + [float((a - b).abs().max())
                                           for a, b in zip(out, ref)])
        k1_f64.append(band_f64_errors(*args, out, ref))
        print(f"kernel vs plain m={m}: " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items()) + "; vs f64 plain: "
            f"kernel {k1_f64[-1][0]:.2e}, f32 plain {k1_f64[-1][1]:.2e}",
            flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"fused_moment vs moment_reference at m={m}: {errs}")
        if not k1_f64[-1][0] <= F64_RATIO * k1_f64[-1][1]:
            fail(f"fused_moment at m={m} is {k1_f64[-1][0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain version's {k1_f64[-1][1]}")
    m2 = flagship_model(n_spec=64, nstreams=8)
    m2.bands[0].thermal_b = np.random.default_rng(0).uniform(
        0.1, 1.0, (m2.profile.nz, 64))
    inp2, cfg2 = m2.build_band(0, device=dev)
    for m in range(cfg2.m_scat + 1):
        args = band_moment_args(inp2, cfg2, m, dev)
        out = fused_band.fused_moment(*args[0], **args[1])
        torch.cuda.synchronize()
        ref = fused_band.moment_reference(*args[0], **args[1])
        errs = {n: rel(a, b) for n, a, b in zip(names, out, ref)}
        e64 = band_f64_errors(*args, out, ref)
        print(f"kernel vs plain K=2 m={m}: " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items()) + "; vs f64 plain: "
            f"kernel {e64[0]:.2e}, f32 plain {e64[1]:.2e}", flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"K=2 fused_moment vs moment_reference at m={m}: {errs}")
        if not e64[0] <= F64_RATIO * e64[1]:
            fail(f"K=2 fused_moment at m={m} is {e64[0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain version's {e64[1]}")

    rrs_model = rrs_sif_model(n_spec=RRS_N_SPEC)
    rrs_inputs, rrs_config, *rrs = inelastic_setup(rrs_model, device=dev)
    if not rrs_config.fused:
        fail("the RRS f32 model on CUDA did not pick the kernel path")
    n_shifts = len(rrs[0])
    rrs_args = [rrs_moment_args(rrs_inputs, rrs_config, *rrs, m, dev)
                for m in range(rrs_config.m_max + 1)]
    kw0 = rrs_args[0][1]
    print(f"RRS config: N={rrs_config.N} nz={rrs_config.nz} "
          f"ndoubl={rrs_config.ndoubl} ns_sched={rrs_config.ns_sched} "
          f"ns_inter={rrs_config.ns_inter} shifts={n_shifts} "
          f"pairs={n_shifts * RRS_N_SPEC}; ie ladder ndoubl={kw0['ndoubl']} "
          f"ns_sched={kw0['ns_sched']} ns_inter={kw0['ns_inter']}",
          flush=True)
    names_ie = ("ieR_mp", "ieR_pm", "ieT_pp", "ieT_mm", "ieJ_p", "ieJ_m")
    rrs_abs_err = 0.0
    edge_model = rrs_sif_model(n_spec=64, nstreams=3, polarization=STOKES_I)
    edge_inputs, edge_config, *edge = inelastic_setup(edge_model, device=dev)
    off = torch.as_tensor([[not 0 <= i + sh < 64 for i in range(64)]
                           for sh in edge[0]], device=dev)
    cases = [("RRS", m, a) for m, a in enumerate(rrs_args)] + [
        ("edge N=6", m, rrs_moment_args(edge_inputs, edge_config, *edge, m,
                                        dev))
        for m in range(edge_config.m_max + 1)]
    k3_plan = fused_rrs.launch_info(
        rrs_config.N, rrs_config.nz,
        fused_rrs.norm_sched(kw0["ns_sched"], kw0["ndoubl"]),
        kw0["ns_inter"])
    print(f"K3 launches at N={rrs_config.N}: {json.dumps(k3_plan)}",
          flush=True)
    k3_f64 = []
    for label, m, (args, kw) in cases:
        out = fused_rrs.fused_moment_rrs(*args, **kw)
        torch.cuda.synchronize()
        ref = fused_rrs.moment_rrs_reference(*args, **kw)
        ops = fused_rrs.rrs_operands(*args, **{
            k: v for k, v in kw.items() if k not in ("ns_sched", "ns_inter")})
        sched = fused_rrs.norm_sched(kw["ns_sched"], kw["ndoubl"])
        nR, n_pts = len(args[11]), args[4].shape[1]
        split = [x.reshape(nR, n_pts, *x.shape[1:]) for x in
                 fused_rrs.moment_rrs_split_reference(
                     ops, args[11], sched, kw["ns_inter"],
                     fused_rrs.pair_shape(ops.d_vec.shape[0],
                                          ops.Em1.shape[0], sched,
                                          kw["ns_inter"])[1])]
        ref64 = fused_rrs._ie_layout(fused_rrs.moment_rrs_body_reference(
            ops._replace(**{f: getattr(ops, f).double()
                            for f in ops._fields}), sched, kw["ns_inter"]),
            nR, n_pts)
        errs = {n: rel(a, b) for n, a, b in zip(names_ie, out, ref)}
        e_split = max(rel(a, b) for a, b in zip(out, split))
        rrs_abs_err = max([rrs_abs_err] + [float((a - b).abs().max())
                                           for a, b in zip(out, ref)])
        e64 = (max(rel(a.double(), b) for a, b in zip(out, ref64)),
               max(rel(a.double(), b) for a, b in zip(ref, ref64)))
        k3_f64.append(e64)
        print(f"K3 vs plain {label} m={m}: " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items()) + f"; vs split plain "
            f"{e_split:.2e}; vs f64 plain: kernel {e64[0]:.2e}, f32 plain "
            f"{e64[1]:.2e}", flush=True)
        if not all(np.isfinite(e) and e <= GATE
                   for e in (*errs.values(), e_split)):
            fail(f"fused_moment_rrs vs moment_rrs_reference {label} m={m}: "
                 f"{errs}, vs moment_rrs_split_reference {e_split}")
        if not e64[0] <= F64_RATIO * e64[1]:
            fail(f"fused_moment_rrs {label} m={m} is {e64[0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain version's {e64[1]}")
        if label.startswith("edge") and not all(
                bool((a[off] == 0).all()) for a in out):
            fail("off-grid RRS pairs did not come out exactly zero")

    from vsmartmom_tpu_torch import default_layout, rt_run_lin
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        rt_solve_jvp)
    t0 = time.perf_counter()
    lin_model = flagship_model(n_spec=LIN_N_SPEC, aerosol=True)
    lin_scene_s = time.perf_counter() - t0
    layout = default_layout(lin_model)
    t0 = time.perf_counter()
    lin_inputs, lin_config, lin_tans = build_tangent_inputs(
        lin_model, 0, layout, device=dev)
    torch.cuda.synchronize()
    lin_tangent_s = time.perf_counter() - t0
    n_par = len(lin_tans)
    if not lin_config.fused or n_par != 8:
        fail("the aerosol flagship on CUDA did not pick the kernel path "
             "with 8 Jacobian parameters")
    print(f"Jacobian config: N={lin_config.N} nz={lin_config.nz} "
          f"C={lin_inputs.Z_pp.shape[1]} ndoubl={lin_config.ndoubl} "
          f"ns_sched={lin_config.ns_sched} ns_inter={lin_config.ns_inter} "
          f"m_max={lin_config.m_max} m_scat={lin_config.m_scat} "
          f"params={layout.names()}; host build {lin_scene_s:.1f} s, "
          f"tangents {lin_tangent_s:.1f} s", flush=True)
    lin_slice = spectral_slice(lin_inputs, lin_config, 0, LIN_SLICE)
    slice_tans = [spectral_slice(t, lin_config, 0, LIN_SLICE)[0]
                  for t in lin_tans]
    outs, refs, f64_errs = [], [], []
    for m in (0, 1, lin_config.m_max):
        args = fused_lin.multitangent_args(lin_slice[0], slice_tans,
                                           lin_slice[1], m, dev)
        outs.append(fused_lin.fused_moment_multitangent(*args))
        torch.cuda.synchronize()
        refs.append(fused_lin.moment_multitangent_reference(*args))
        f64_errs.append(primal_f64_errors(args, outs[-1][0], refs[-1][0]))
    k2_prim, k2_tan, k2_abs_err = mt_errors(outs, refs)
    print(f"K2 vs plain (nSpec={LIN_SLICE}, m=0,1,{lin_config.m_max}): "
          f"primal={k2_prim:.2e} tangents per parameter "
          + " ".join(f"{e:.2e}" for e in k2_tan)
          + f"; primal vs f64 plain: kernel "
          f"{max(e[0] for e in f64_errs):.2e}, f32 plain "
          f"{max(e[1] for e in f64_errs):.2e}", flush=True)
    if not (np.isfinite(k2_prim) and k2_prim <= GATE
            and all(np.isfinite(e) and e <= TAN_GATE for e in k2_tan)):
        fail(f"fused_moment_multitangent vs moment_multitangent_reference: "
             f"primal {k2_prim}, tangents {k2_tan}")

    # ---- 3. the main path, counted ----
    fused_band.fused_moment.launches = 0
    R, T = rt_run(model, device=dev, spectral_chunk=N_CHUNK)
    torch.cuda.synchronize()
    launches = fused_band.fused_moment.launches
    want = N_CHUNKS * (config.m_scat + 1)
    print(f"main path: rt_run nSpec={N_SPEC_TOTAL} in {N_CHUNKS} chunks, "
          f"fused_moment launches={launches} (want {want})", flush=True)
    if launches != want:
        fail(f"fused_moment launched {launches} times, want {want}")
    if R.shape != (9, 4, N_SPEC_TOTAL) or not (np.isfinite(R).all()
                                               and np.isfinite(T).all()):
        fail(f"R/T not finite or of the wrong shape {R.shape}")
    cfg_plain = dataclasses.replace(chunk0[1], fused=False, m_scat=-1,
                                    ns_sched=(), ns_inter=6)
    plain = rt_solve(chunk0[0], cfg_plain, dev)
    kern = rt_solve(*chunk0, dev)
    e_plain = {k: rel(kern[k], plain[k]) for k in ("R", "T")}
    print(f"kernel path vs plain path (chunk 0): R={e_plain['R']:.2e} "
          f"T={e_plain['T']:.2e}", flush=True)
    if not all(e <= GATE for e in e_plain.values()):
        fail(f"kernel path vs plain path: {e_plain}")
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "flagship_ref_f64.npz")
    R16, T16 = rt_run(flagship_model(n_spec=ref["R"].shape[-1], nstreams=8),
                      device=dev)
    e_ref = {"R": rel(R16, ref["R"]), "T": rel(T16, ref["T"])}
    print(f"kernel path vs JAX f64 reference (nSpec={ref['R'].shape[-1]}): "
          f"R={e_ref['R']:.2e} T={e_ref['T']:.2e}", flush=True)
    if not all(e <= GATE for e in e_ref.values()):
        fail(f"port vs stored JAX reference: {e_ref}")

    rrs_counted = {"fused_moment": fused_band.fused_moment,
                   "fused_moment_rrs": fused_rrs.fused_moment_rrs,
                   "rrs_diagonal": fused_rrs._launch_diagonal}
    for fn in rrs_counted.values():
        fn.launches = 0
    ie_out = dict(zip(("R", "T", "ieR", "ieT"),
                      rt_run_inelastic(rrs_model, device=dev)))
    torch.cuda.synchronize()
    rrs_launches = {k: fn.launches for k, fn in rrs_counted.items()}
    n_rc = min(n_shifts, 32768 // RRS_N_SPEC)
    want_rrs = {"fused_moment": rrs_config.m_max + 1,
                "fused_moment_rrs": (rrs_config.m_max + 1)
                * -(-n_shifts // n_rc)}
    want_rrs["rrs_diagonal"] = want_rrs["fused_moment_rrs"]
    print(f"main path: rt_run_inelastic nSpec={RRS_N_SPEC}, launches "
          f"{rrs_launches} (want {want_rrs})", flush=True)
    if rrs_launches != want_rrs:
        fail(f"RRS path launches {rrs_launches}, want {want_rrs}")
    for k, v in ie_out.items():
        if v.shape != (3, 3, RRS_N_SPEC) or not np.isfinite(v).all():
            fail(f"RRS {k} not finite or of the wrong shape {v.shape}")
    if not np.abs(ie_out["ieR"]).max() > 0:
        fail("the RRS path returned no inelastic signal")
    plain = rt_solve_rrs(rrs_inputs, dataclasses.replace(rrs_config,
                                                         fused=False),
                         *rrs, device=dev)
    plain = {k: v.cpu().numpy() for k, v in plain.items()}
    full = rt_solve_rrs_fused(rrs_inputs, rrs_config, *rrs, device=dev,
                              ie_fullres=True)
    e_rrs = {k: rel(ie_out[k], plain[k]) for k in ie_out}
    # Total radiance R + ieR against max|R|, the signal a retrieval reads.
    e_rrs["R+ieR"] = float(np.abs(ie_out["R"] + ie_out["ieR"] - plain["R"]
                                  - plain["ieR"]).max()
                           / np.abs(plain["R"]).max())
    e_full = {k: rel(full[k].cpu(), plain[k]) for k in ie_out}
    print("RRS kernel path vs plain path: " + " ".join(
        f"{k}={e:.2e}" for k, e in e_rrs.items()) + "; ie_fullres: " +
        " ".join(f"{k}={e:.2e}" for k, e in e_full.items()), flush=True)
    if not (e_rrs["R"] <= GATE and e_rrs["ieR"] <= IE_GATE
            and e_rrs["R+ieR"] <= GATE
            and e_full["R"] <= GATE and e_full["ieR"] <= GATE):
        fail(f"RRS kernel path vs plain path: {e_rrs}, fullres {e_full}")
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "rrs_ref_f64.npz")
    small = rrs_ref_model(ref["R"].shape[-1])
    e_sref = {k: rel(v, ref[k]) for k, v in zip(
        ("R", "T", "ieR", "ieT"),
        rt_run_inelastic(small, device=dev, ie_fullres=True))}
    print("RRS kernel path (ie_fullres) vs JAX f64 reference (nSpec=16): "
          + " ".join(f"{k}={e:.2e}" for k, e in e_sref.items()), flush=True)
    if not (e_sref["R"] <= GATE and e_sref["ieR"] <= GATE):
        fail(f"RRS port vs stored JAX reference: {e_sref}")

    counted = {"fused_moment": fused_band.fused_moment,
               "fused_moment_rrs": fused_rrs.fused_moment_rrs,
               "rrs_diagonal": fused_rrs._launch_diagonal,
               "fused_moment_multitangent":
                   fused_lin.fused_moment_multitangent}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with timed_calls(fused_lin, "rt_solve_multitangent") as lin_times:
        R, T, dR, dT = rt_run_lin(lin_model, layout=layout, device=dev)
    torch.cuda.synchronize()
    lin_e2e_s = time.perf_counter() - t0
    lin_launches = {k: fn.launches for k, fn in counted.items()}
    want_lin = {"fused_moment": 0, "fused_moment_rrs": 0, "rrs_diagonal": 0,
                "fused_moment_multitangent": lin_config.m_scat + 1}
    print(f"main path: rt_run_lin nSpec={LIN_N_SPEC}, {n_par} parameters, "
          f"launches {lin_launches} (want {want_lin}), {lin_e2e_s:.1f} s",
          flush=True)
    if lin_launches != want_lin:
        fail(f"Jacobian path launches {lin_launches}, want {want_lin}")
    if dR.shape != (9, 4, LIN_N_SPEC, n_par) or not all(
            np.isfinite(x).all() for x in (R, T, dR, dT)):
        fail(f"rt_run_lin outputs not finite or dR of shape {dR.shape}")
    # The routes on moments 0..ROUTE_CHECK_M (the jvp route is
    # launch-bound; K2 was held to its plain version above).
    cut = dataclasses.replace(lin_slice[1], m_max=min(lin_config.m_max,
                                                      ROUTE_CHECK_M))
    kern = fused_lin.rt_solve_multitangent(lin_slice[0], slice_tans, cut,
                                           dev)
    plain = rt_solve_jvp(lin_slice[0], slice_tans,
                         dataclasses.replace(cut, fused=False), dev)
    e_route = [rel(kern[0], plain[0])] + [rel(kern[2][q], plain[2][q])
                                          for q in range(n_par)]
    print(f"Jacobian kernel route vs plain jvp route (nSpec={LIN_SLICE}, "
          f"m=0..{cut.m_max}): "
          f"R={e_route[0]:.2e} dR per parameter "
          + " ".join(f"{e:.2e}" for e in e_route[1:])
          + f"; dT={rel(kern[3], plain[3]):.2e}", flush=True)
    if not (e_route[0] <= GATE and all(e <= TAN_GATE for e in e_route[1:])):
        fail(f"Jacobian kernel route vs plain route: {e_route}")
    fused_band.fused_moment.launches = 0
    R_fwd, _ = rt_run(lin_model, device=dev, spectral_chunk=LIN_N_SPEC)
    e_fwd = rel(R, R_fwd)
    print(f"rt_run of the aerosol flagship: fused_moment launches="
          f"{fused_band.fused_moment.launches} (want "
          f"{lin_config.m_scat + 1}), R vs rt_run_lin's R {e_fwd:.2e}",
          flush=True)
    if fused_band.fused_moment.launches != lin_config.m_scat + 1 \
            or not e_fwd <= GATE:
        fail(f"rt_run vs rt_run_lin on the aerosol flagship: {e_fwd}")
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "lin_ref_f64.npz")
    small_model = lin_ref_model()
    small = dict(zip(("R", "T", "dR", "dT"),
                     rt_run_lin(small_model, device=dev)))
    names = default_layout(small_model).names()
    e_lref, own, control, ok = lin_ref_gates(small, ref, names)
    print("Jacobian kernel path vs JAX f64 reference (small aerosol scene): "
          + " ".join(f"{k}={e:.2e}" for k, e in e_lref.items())
          + "; dR per parameter on its own scale "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(names, own))
          + "; height dR 1% off " + " ".join(f"{e:.2e}" for e in control),
          flush=True)
    if not ok:
        fail(f"Jacobian port vs stored JAX reference: {e_lref}, per "
             f"parameter {own}, control {control}")

    # ---- 4. timing ----
    chunks = [spectral_slice(inputs, config, a, a + N_CHUNK)
              for a in range(0, N_SPEC_TOTAL, N_CHUNK)]
    times = []
    for rep in range(4):                           # 1 warm-up + best of 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [rt_solve(i, c, dev)["R"] for i, c in chunks]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            fail("non-finite R in the timed solve")
    pts_per_s = N_SPEC_TOTAL / min(times[1:])
    t0 = time.perf_counter()
    rt_run(model, device=dev, spectral_chunk=N_CHUNK)
    e2e_s = time.perf_counter() - t0

    args = moment_args[0]
    k_ms = cuda_time_ms(lambda: fused_band.fused_moment(*args[0], **args[1]))
    p_ms = cuda_time_ms(
        lambda: fused_band.moment_reference(*args[0], **args[1]), reps=3)
    out = fused_band.fused_moment(*args[0], **args[1])
    flops = moment_flops(config, N_CHUNK)
    k1_bytes = moment_bytes(args, out)
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, \
        k1_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(json.dumps({
        "card": smi, "pts_per_s": pts_per_s, "solve_s": min(times[1:]),
        "rt_run_e2e_s": e2e_s, "n_spec": N_SPEC_TOTAL,
        "moment_launch": {"n_spec": N_CHUNK, "kernel_ms": k_ms,
                          "plain_ms": p_ms, "bound_ms": bound_ms,
                          "bound_share": bound_ms / k_ms,
                          "flops": flops, "bytes": k1_bytes,
                          "achieved_tflops": flops / k_ms / 1e9,
                          "plan": k1_plan, "f64_kernel_plain": k1_f64}}),
        flush=True)

    times = []
    for _ in range(4):                           # 1 warm-up + best of 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = rt_solve_rrs_fused(rrs_inputs, rrs_config, *rrs, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(o["ieR"]).all()):
            fail("non-finite ieR in the timed RRS solve")
    rrs_pts_per_s = RRS_N_SPEC / min(times[1:])
    t0 = time.perf_counter()
    rt_run_inelastic(rrs_model, device=dev)
    rrs_e2e_s = time.perf_counter() - t0

    args, kw = rrs_args[0]
    ops = fused_rrs.rrs_operands(*args, **{k: v for k, v in kw.items()
                                          if k not in ("ns_sched",
                                                       "ns_inter")})
    sched = fused_rrs.norm_sched(kw["ns_sched"], kw["ndoubl"])
    k3_pl, k3_pairs, k3_threads = fused_rrs.kernel_plan(
        ops, args[11], sched, kw["ns_inter"])
    k3_ms = cuda_time_ms(lambda: fused_rrs._launch_kernel(
        ops, args[11], sched, kw["ns_inter"]), reps=3)
    store = fused_rrs._launch_diagonal(ops, k3_pl)
    k3_diag_ms = cuda_time_ms(lambda: fused_rrs._launch_diagonal(ops, k3_pl),
                              reps=3)
    k3_pair_ms = cuda_time_ms(lambda: fused_rrs._launch_pairs(
        ops, k3_pl, k3_pairs, k3_threads, store), reps=3)
    k3_plain_ms = cuda_time_ms(lambda: fused_rrs.moment_rrs_body_reference(
        ops, sched, kw["ns_inter"]), reps=3)
    # The split plain version's two halves (the kernels' plain versions).
    ref_store = fused_rrs.diagonal_store(ops, k3_pl)
    k3_diag_plain_ms = cuda_time_ms(
        lambda: fused_rrs.diagonal_store(ops, k3_pl), reps=2)
    k3_pair_plain_ms = cuda_time_ms(lambda: fused_rrs.pair_recurrence(
        ops, k3_pl, k3_pairs, ref_store), reps=2)
    N3, LD3 = rrs_config.N, (rrs_config.N + 3) & ~3
    kern_m = store[0].reshape(*store[0].shape[:2], N3, LD3)[..., :N3]
    diag_abs_err = float((kern_m - ref_store[0]).abs().max())
    diag_rel = rel(kern_m, ref_store[0])
    if not (np.isfinite(diag_rel) and diag_rel <= GATE):
        fail(f"K3's diagonal store vs diagonal_store: {diag_rel}")
    out = fused_rrs._launch_pairs(ops, k3_pl, k3_pairs, k3_threads, store)
    n_on = int(k3_pairs.shape[0])
    k3_flops = {c: rrs_flops(ops, RRS_N_SPEC, n_on, sched, kw["ns_inter"],
                             c)
                for c in ("least", "pairs", "points", "block", "dense")}
    in_bytes = nbytes(*ops)
    k3_bytes = in_bytes + nbytes(*out)
    store_bytes = nbytes(*store)
    # The diagonal launch reads the points' l1 row tables (pairs 0..s-1).
    diag_in = nbytes(ops.Z_pp, ops.Z_mp, ops.geom, ops.d_vec, ops.src_jp,
                     ops.src_jm, ops.src_ek, ops.w_over[:, :, :RRS_N_SPEC, 1],
                     ops.Em1[:, :RRS_N_SPEC, N3:],
                     ops.dtau[:, :RRS_N_SPEC, 1])
    bounds = {}
    for part, flops, nb in (("all", k3_flops["least"], k3_bytes),
                            ("pairs", k3_flops["pairs"],
                             in_bytes + nbytes(*out) + store_bytes),
                            ("points", k3_flops["points"],
                             diag_in + store_bytes)):
        t_ops, t_mem = flops / FP32_PEAK_FLOPS * 1e3, nb / HBM_BYTES_PER_S * 1e3
        bounds[part] = (max(t_ops, t_mem),
                        "operations" if t_ops >= t_mem else "bytes", nb)
    k3_bound = bounds["all"][0]
    print(json.dumps({
        "card": smi, "rrs_pts_per_s": rrs_pts_per_s,
        "rrs_solve_s": min(times[1:]), "rrs_solve_all_s": times,
        "rt_run_inelastic_e2e_s": rrs_e2e_s, "n_spec": RRS_N_SPEC,
        "n_shifts": n_shifts, "launches": rrs_launches,
        "rrs_launch": {"pairs": n_shifts * RRS_N_SPEC, "pairs_on_grid": n_on,
                       "kernel_ms": k3_ms, "diag_ms": k3_diag_ms,
                       "pair_ms": k3_pair_ms, "plain_ms": k3_plain_ms,
                       "diag_plain_ms": k3_diag_plain_ms,
                       "pair_plain_ms": k3_pair_plain_ms,
                       "bound_ms": k3_bound,
                       "bound_share": k3_bound / k3_ms,
                       "diag_bound_ms": bounds["points"][0],
                       "pair_bound_ms": bounds["pairs"][0],
                       "flops": k3_flops["least"],
                       "flops_pairs": k3_flops["pairs"],
                       "flops_points": k3_flops["points"],
                       "flops_block": k3_flops["block"],
                       "flops_dense": k3_flops["dense"],
                       "bytes": k3_bytes, "store_bytes": store_bytes,
                       "diag_store_err": diag_rel,
                       "achieved_tflops": k3_flops["least"] / k3_ms / 1e9,
                       "achieved_tflops_pairs": k3_flops["pairs"]
                       / k3_pair_ms / 1e9,
                       "plan": {**k3_plan, "records": len(k3_pl.table),
                                "phases": k3_pl.n_phases,
                                "prefetched": k3_pl.n_prefetched,
                                "staged_matrices_a_pair": k3_pl.n_stage_mats,
                                "store_entries": [k3_pl.n_mat_entries,
                                                  k3_pl.n_vec_entries]},
                       "f64_kernel_plain": k3_f64}}),
        flush=True)
    # The solve inside the counted rt_run_lin above (tangents prebuilt by
    # the entry, K2 loaded by the checks before it), timed in that run.
    if len(lin_times) != 1:
        fail(f"rt_run_lin made {len(lin_times)} multitangent solves")
    lin_solve_s = lin_times[0]
    args = fused_lin.multitangent_args(lin_inputs, lin_tans, lin_config, 0,
                                       dev)
    k2_ms = cuda_time_ms(lambda: fused_lin._launch_kernel(*args), reps=3)
    k2_plain_ms = cuda_time_ms(
        lambda: fused_lin.moment_multitangent_reference(*args), reps=2)
    out = fused_lin._launch_kernel(*args)
    k2_plan = mt_plan_report(lin_config, n_par)
    primal_flops = moment_flops(lin_config, LIN_N_SPEC)
    k2_flops = (1 + 2 * n_par) * primal_flops
    k2_bytes = sum(x.numel() * x.element_size()
                   for x in (*args[0], *args[1], *out[0], *out[1]))
    k2_ops, k2_mem = k2_flops / FP32_PEAK_FLOPS * 1e3, \
        k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_bound = max(k2_ops, k2_mem)
    print(json.dumps({
        "card": smi, "lin_pts_per_s": LIN_N_SPEC / lin_solve_s,
        "lin_tangent_pts_per_s": LIN_N_SPEC * n_par / lin_solve_s,
        "lin_solve_s": lin_solve_s,
        "rt_run_lin_e2e_s": lin_e2e_s, "scene_build_s": lin_scene_s,
        "tangent_build_s": lin_tangent_s, "n_spec": LIN_N_SPEC,
        "n_params": n_par, "launches": lin_launches,
        "mt_launch": {"n_spec": LIN_N_SPEC, "kernel_ms": k2_ms,
                      "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
                      "bound_share": k2_bound / k2_ms, "flops": k2_flops,
                      "flops_kernel": k2_plan["work"] * primal_flops,
                      "bytes": k2_bytes,
                      "achieved_tflops": k2_flops / k2_ms / 1e9,
                      "achieved_tflops_kernel": k2_plan["work"]
                      * primal_flops / k2_ms / 1e9,
                      "plan": k2_plan}}), flush=True)
    phases_s = {"build and phases 2-4": time.perf_counter() - script_t0}

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases_s[fn.__name__] = time.perf_counter() - t0
        return out
    k5_entry = phase(ms_phase, dev, smi)
    k4_entry = phase(layer_chain_phase, dev, smi, inputs, config)
    probe_entries = phase(probes_phase, smi)
    k1p_entry = phase(thermal_lin_phase, dev, smi)
    phase(absorption_phase, dev, smi)
    phase(raman_phase, dev, smi)
    phase(geoschem_phase, dev, smi)
    phase(surfaces_phase, dev, smi)
    phase(entries_4d_phase, dev, smi)
    phase(sharding_phase, dev, smi)
    wide_entries = phase(wide_phase, dev, smi)
    print(json.dumps({"card": smi, "phases_s": phases_s}), flush=True)
    print(f"chip_smoke.py: {time.perf_counter() - script_t0:.1f} s, the "
          "kernels' build included", flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_moment", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_band.cu",
        "replaces": "vsmartmom_tpu/ops/fused_band.py:469",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None}, {
        "name": "fused_moment_rrs", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_rrs.cu",
        "replaces": "vsmartmom_tpu/ops/fused_rrs.py:366",
        "launches": rrs_launches["fused_moment_rrs"],
        "max_abs_err": rrs_abs_err, "ms": k3_pair_ms,
        "plain_ms": k3_pair_plain_ms, "bound_ms": bounds["pairs"][0],
        "bound_by": bounds["pairs"][1], "library_ms": None}, {
        "name": "rrs_diagonal", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_rrs.cu",
        "replaces": "vsmartmom_tpu/ops/fused_rrs.py:366",
        "launches": rrs_launches["rrs_diagonal"],
        "max_abs_err": diag_abs_err, "ms": k3_diag_ms,
        "plain_ms": k3_diag_plain_ms, "bound_ms": bounds["points"][0],
        "bound_by": bounds["points"][1], "library_ms": None}, {
        "name": "fused_moment_multitangent", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_lin.cu",
        "replaces": "vsmartmom_tpu/ops/fused_lin.py:214",
        "launches": lin_launches["fused_moment_multitangent"],
        "max_abs_err": k2_abs_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": "operations" if k2_ops >= k2_mem else "bytes",
        "library_ms": None}, k1p_entry, k5_entry, k4_entry,
        *probe_entries, *wide_entries]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
