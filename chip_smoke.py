"""Smoke run of the PyTorch/CUDA port (``pysdm_tpu_torch``) on one NVIDIA GPU.

Run from the root of the checkout: ``python3 chip_smoke.py``. Phases:

0. environment: the card's name and power limit (nvidia-smi), torch, CUDA,
   nvcc, whether triton imports;
1. build of every CUDA kernel from ``pysdm_tpu_torch/csrc`` (six sources,
   the pH solve's ``chemistry.cu`` among them), one nvcc per source, all
   started together;
2. K1 (mirror coalescence) against its plain PyTorch twin on the card, on
   random states with dead slots, ties and multiplicities up to 2^40, at 2^16
   and 2^20 slots: multiplicities exactly, extensive rows to rtol 1e-6
   (float32) or 1e-12 (float64), rate sums to rtol 1e-5; three launches on
   the same inputs bit-equal, rate sums included, and launches on two
   inputs queued on two streams at once bit-equal to the launches alone;
   then the device time of kernel and twin at 2^20 (CUDA events), the
   kernel's on one input (which stays in the L2) and over a rotation of
   four inputs (which does not);
3. the box path: ``bench.py``'s box (Golovin b = 1.5e3, 2^20 super-droplets,
   dv = 1e6 m^3, dt = 1 s, non-adaptive) on the ``GPU`` backend, run(1) as
   warm-up, then run(100) timed; launch counts are reset just before and
   read just after, and K1 must have launched once per substep; the same
   step is then timed with the plain twin in the kernel's place (timing
   only), and a 2^16 box is run through kernel and twin and compared;
4. the adaptive box: 5 steps at dt = 10 s, launches == substeps;
5. K3 (the per-drop condensation solve) against its twin on the card at 2^17
   and 2^20 drops in five cells (supersaturated growing drops, haze settled
   at its float32 equilibrium, an inactive cell, dead and zero-mass drops,
   a non-finite root): success equal drop for drop, log-mass within
   2 rtol_x |x_old| + 2e-5 (see ``compare_k3``); the same drops in a random
   order (blocks whose threads compute their own cell's state) bit-equal
   to the sorted ones and within the same bound of the twin; then the
   device time of
   kernel and twin at both sizes, the kernel's time on three uniform sets
   of rows (every drop growing, every drop haze at equilibrium, every cell
   inactive), and the minfun evaluations the rows need beside what plain
   halving would need;
6. the parcel path: ``bench.py``'s parcel (BASELINE config #3: 2^17
   super-droplets, adaptive, w = 2 m/s) on the ``GPU`` backend, run(1) as
   warm-up, then run(100) timed with K3's count reset just before and read
   just after: it must equal the per-drop solves the solver counted, fake
   and real. The run goes on to 1000 steps (2 km of ascent) and checks
   success, 1.0005 < RH_max < 1.05, liquid water above 1e-4 kg/kg, a mean
   radius between 5 and 50 um and qv plus liquid conserved; then 10 more
   steps through K3 and 10 with the twin in its place (timing only);
7. the parcel on the card (float32, K3) against the port's CPU float64
   backend, 64 drops, 50 steps, adaptive and not: water masses to rtol 2e-3
   and qv to rtol 1e-4. From qv0 = 0.0158 the parcel stays subsaturated in
   50 steps (the haze grows); a third, non-adaptive case starts from qv0 =
   0.0225 and activates the drops within the 50 steps;
8. K4 (the prefix sum) against torch.cumsum and float64 sums at 2^20, at
   the warm rain's 2.56 M, at 2.56 M + 12345, below one tile and at n = 1:
   integers exactly, float32 within 1e-5 of the float64 prefix and three
   runs bit-equal; the rows of a (4, n) call bit-equal to their 1D scans;
   two scans queued on two streams at once bit-equal to the scans alone;
   then the device time of the kernel, of a (4, n) call and of
   torch.cumsum, on one input (which stays in the L2) and over a rotation
   of eight inputs (which does not);
9. K2 (sort-croupier coalescence) against its twin at 2.56 M slots;
10. the warm rain (config #5, 25 x 25 cells x 2^12 super-droplets) through
   ``make_simulation`` on the card, 30 steps after one, with K2, K3 and K4
   launches (and K4's rows) counted; the per-cell float32 sums against
   float64; then one more step whose first condensation solve is captured:
   on that solve's inputs (2.56 M drops sorted into 625 cells) K3 on the
   shuffled drops bit-equal to the sorted ones and K3 against its twin
   (``compare_k3_near_saturation``), its time and its minfun evaluations;
11. ``tests/smoke/test_kinematic_2d.py``'s 8x8 scenario on the card, and a
   float32 card spin-up against the CPU float64 one;
12. the warm-rain step with K2's and K4's twins in their places (timing);
13. K5 (collision with breakup) against its twin on the card at 2^17 and
   2^20, with config #2's functions and with a set that bounces and
   coalesces too (``compare_k5`` states the bounds); then the device time
   of kernel and twin; determinism as in phase 2; the kernel's time over a
   rotation of 16 random states at 2^17 (device memory); then K5 on 16
   substeps captured from config #2's main path (phase 14's recipe, one
   warm-up step): against the twin and timed, on the first state and over
   the rotation of all 16;
14. config #2, the de Jong/Mackay 2023 breakup box, through ``bench.py``'s
   recipe (2^17 super-droplets, adaptive, dt = 1 s) on the ``GPU``
   backend, run(1) as warm-up, then run(100) timed with K5's count reset
   just before and read just after: it must equal the collision substeps;
   water mass to 1e-5 (the bench's assert), multiplicities >= 0,
   coalescence and breakup rates > 0; then 10 steps through K5 and 10 with
   its twin in its place (timing only);
15. config #2 through its model entry point, ``run_box_breakup`` on the
   card at 2^17: finite spectra, each read twice bit-equal (deterministic
   sums), the liquid under dv/dlnr conserved, rates;
16. config #4, the Shipway and Hill 2012 1D column, through ``Simulation``
   on the card at the JAX model's defaults (dz = 25 m, dt = 1 s, 145 cells)
   with 2^12 super-droplets per cell (593,920): run(1) as warm-up, then
   run(100) timed below cloud; on to t = 400 s, where it must have formed
   its cloud (max qc > 0.05 g/kg, at least 10 cells above 1e-5 kg/kg, peak
   supersaturation > 0, ``condensation_success``, multiplicities >= 0),
   every product of the default ``Simulation`` read twice on that state
   (bit-equal, but for the two that reset their counter on read); one more
   step whose first K2 substep, first K3 solve and first K4 scan of each
   dtype and rank are captured, and each kernel held against its twin on
   those inputs at the bounds of phases 9, 10 and 8 (``_column_kernels_vs_
   twins``); the water budget over 30 steps, precipitation included, to
   5%; then run(50)
   timed in cloud. Around each timed window the launches of K2, K3 and K4
   (and K4's rows) are set to 0 and read: K2's must equal the collision
   substeps, K3's the condensation solves;
17. the published-profile scenario of ``tests/smoke/test_kinematic_1d.py``
   (128 super-droplets per cell, dt = 30 s, dz = 60 m, 50 steps, seed 44)
   on the card in float32, with that test's statistics and bounds;
18. K1 with the geometric kernels (``Geometric`` and ``SimpleGeometric``,
   two attribute rows) against its twin on the card at 2^16 and 2^20 on
   random states as in phase 2 (the same bounds), determinism as there,
   and Geometric's device time at 2^20 on one input and rotated;
19. ``shima_et_al_2009.run`` (config #1's physics) at 2^20 on the card:
   3600 steps, dv/dlnr against the Golovin solution at t = 1200 s (rmse
   under the JAX test's 0.15), the mass under the spectrum to 5e-2 and the
   liquid to 1e-6, K1 launches = substeps, ``WallTime`` positive and
   within the host clock around the call; then ``dejong_azimi.run_box`` and
   ``bartman_2020_fig_4`` at their defaults on the card with the JAX
   tests' bounds (``_box_model_entry_points``);
20. ``berry_1967.run`` at 2^20 on the card (Geometric on K1, Gunn-Kinzer
   fall velocities): the mean radius grows, liquid to 1e-6, K1 launches =
   substeps; one more substep captured and K1 held against its twin on it;
21. ``bulenok_2023_benchmark`` at 2^17 and 2^20, 64 steps, on the card
   (K5): pair-updates/s, the final mean mass within ``BULENOK_FACTOR`` of
   eq. 13, multiplicities >= 0, K5 launches = substeps; K5 held against
   its twin (``compare_k5``) on a substep captured from the 2^20 run;
22. de Jong and Azimi's ``Settings1D`` (the column without condensation,
   Golovin b = 5e3, 145 cells x 2^12) through the column's ``Simulation``
   on the card, 300 steps: K2 launches = collision substeps, K4 launched,
   a coalescence rate > 0, liquid conserved to 1e-5 with the
   precipitation counted; every liquid-phase product that applies to such
   a column read twice, bit-equal but for those that reset on read; then
   K2 and K4 held against their twins on a captured substep and scan
   (``_column_kernels_vs_twins``);
23. K3 on a mixed-phase state: 2^17 drops of ``k3_rows``, every fourth
   frozen (a negative signed mass), against its twin on the card
   (``compare_k3``), the ice bit-equal to its input and solved in both, the
   liquid drops bit-equal to the same rows without ice; its time beside the
   rows all liquid, in turns, and its bound;
24. ``alpert_and_knopf_2016.simulation`` (time-dependent immersion freezing
   in a box) with ``TestAlpertKnopf2016``'s settings at 1000 drops and at
   2^17: the unfrozen fraction within 4 binomial sigma of exp(-J A t) at
   every output, and monotone;
25. ``spichtinger_et_al_2023.Simulation`` (homogeneous freezing and
   deposition on the nucleated ice, K3 on a state with ice) at 2^17,
   ``Simulation.run`` of 400 steps with K3's and K4's counts set to 0
   just before and read just after (K3 launches = solves, no K4): the
   assertions of ``TestSpichtingerEtAl2023`` (RH_ice < 1.1 at the end at
   the test's 32 super-droplets, run first, and below its peak at 2^17,
   where neither package ends below 1.1) and the total water to 1e-5; then ms/step, K3
   launches, host reads, kernels and the device's busy share over 20
   steps after the burst (``torch.profiler``);
26. ``abade_and_albuquerque_2024.Simulation`` (singular immersion freezing
   and deposition beside condensation) at the test's 64 super-droplets and
   at 2^17, 700 steps: the assertions of ``TestAbadeAndAlbuquerque2024``,
   toggles included (the liquid cloud before the ice at 64 only: at 2^17
   a warm-tail INP glaciates the parcel at cloud base);
27. ``niedermeier_et_al_2014.Simulation`` with
   ``TestNiedermeier2014``'s settings: ice forms, the parcel cools;
28. float32 records: the largest |Delta log10 J_hom| between the card's
   float32 and the CPU's float64 for Koop2000, Koop_Correction and
   KoopMurray2016 over their admitted ranges, and the drops of the
   Spichtinger parcel (2^17, 100 steps through the burst) whose freezing
   probability is positive in float64 and zero in float32;
29. K1a (mirror coalescence with the kernel x norm and u01 rows given)
   and its Parameterized form (the Berry 1967 kernel evaluated in the
   body) against their twins on the card, multiplicities and rows bit for
   bit: on Berry 1967's state with Hydrodynamic at 2^13 and 2^20, K1a also on random states at 2^20 (float32 and float64
   rows); three launches bit-equal, and two streams, for each at both
   widths; the device time of each and of its twin at both widths, K1a's
   also over a rotation of eight inputs at 2^20;
30. ``berry_1967.run`` with ``Hydrodynamic`` and with ``Electric`` at the
   model's 2^13 super-droplets over its 1800 steps on the card: launches
   of K1a's Parameterized form = substeps and none of K1a, the liquid to
   1e-6, the mean radius grows; each run's first substep held to its
   twin; ms/step, host reads, device kernels and busy share over 5
   profiled steps; then 100 adaptive Hydrodynamic steps, whose substep
   choice reads the kernel's values: K1a launches = substeps, the first
   held to its twin;
31. de Jong/Mackay 2023's box with Straub 2010's Ec and fragments (the
   float64 breakup path) at 2^17, adaptive, 100 steps, through
   ``run_box_breakup``, again with ``handle_all_breakups``, and through a
   builder on the sort croupier: the liquid to 1e-6, rates finite and
   non-negative, breakups; ms/step, substeps and host reads a step, device
   kernels and busy share; on the sort croupier K4's launches in the run
   (its count set to 0 just before and read just after) and K4 against
   its twin on every scan of one more step; the number at 50 and 100 s
   against a float64 CPU run at the same seed within
   ``STRAUB_NUMBER_RTOL``;
32. ``bieli_et_al_2022.run`` at 2^12 for its three Ec: M1 to 1e-6, M0
   falls at Ec = 1, M0 and M2 against a float64 CPU run within
   ``BIELI_MOMENT_RTOL``; ms/step, device kernels and busy share;
33. the box of ``tests/smoke/test_box_breakup.py``'s pure breakup (2^10,
   ConstantK, four fragments) with ``handle_all_breakups`` over its 10
   steps on the card: the loop's iterations, host reads and ms of each
   step, the water mass to 1e-6, the multiplicity grown; again with the
   loop reading after every iteration, the same multiplicities;
34. K3 for each variant set of ``K3_VARIANT_SETS`` (the rest of physics/:
   every saturation vapour pressure, latent heat, diffusion thermics and
   kinetics, ventilation and surface-tension variant at least once) at
   2^17 and 2^20 drops of ``k3_variant_rows``: the regimes, kernel against
   twin (``compare_k3``), the drops shuffled bit-equal, the growing cell
   brought to RH = 1.0002 (``compare_k3_near_saturation``, at 2^17), the
   minfun evaluations, the device time of kernel and twin and the bound;
   then the parcel slice's set bit-equal to the kernel of the build
   before the variant sets (``K3_PARENT_COMMIT``'s ``condensation.cu``,
   checked by its blob id, from ``K3_PARENT_DIR`` or git; skipped where
   neither has it), both timed in turns;
35. ``lowe_et_al_2019.Simulation``: the JAX test (``AerosolMarine(Forg=0.2)``,
   16 per mode, dz = 5 m) with ``Constant`` and with the film, CDNC higher
   with the film; the film at 2^16 per mode over the 200 m ascent against
   a float64 CPU run at 2^11 per mode (S_max to 10%, CDNC to 5%);
36. ``jensen_and_nugent_2017.Simulation`` (Sc, pristine, GCCN): the JAX
   test's 24 super-droplets and 600 steps at its bounds, then 2^17 with
   gravitational coalescence (K1 launches = collision substeps);
37. ``yang_et_al_2018.Simulation`` at the JAX test's bounds with 32
   super-droplets and at 2^17 (``yang_settings``), 2400 s each, and
   ``arabas_and_shima_2017.Simulation`` at the JAX test's settings. In
   phases 35-37 K3's launches equal the condensation solves;
38. Morrison & Grabowski 2007's strato-cumulus with singular immersion
   freezing on the mixed-phase grid (``Bigg_1953`` with a 33 K median,
   ``MixedPhaseSpheres``) at config #5's width, 25 x 25 x 2^12, through
   ``make_simulation`` on the card, one step and 30 timed: the collision
   route "float64" (the max-merged freezing temperature), no K2 launch,
   K3 launches = solves, K4 counted, one collision read per substep and
   one a step; the total water to 1e-3 with the precipitation summed step
   by step on the device, multiplicities >= 0, no ice, every final
   freezing temperature one of the initial ones and fewer distinct; one
   more step's K3 solve and K4 scans against their twins and its first
   collision substep's per-cell rates (``compute_gamma``) against float64
   host sums, a step with
   collisions off that leaves the multiset of (T_fz, dry volume, kappa
   times dry volume) rows as it was (the shared sort carries the max
   row), 3 profiled steps; then the JAX test's 6 x 6 x 8 case at its
   bounds;
39. ``bartman_et_al_2021.benchmark`` on the card at 2^5, 2^8 and 2^12 per
   cell of the 25 x 25 warm rain, 30 timed steps each, K2, K3 and K4
   launches counted over the window the harness's clock sees; at 2^12
   they equal phase 10's; at 2^5 and 2^8 one more step's K2 substep, K3
   solve and K4 scans against their twins;
40. ``pyrcel`` (2 x 16 and 2 x 2^16), ``grabowski_and_pawlowska_2023``
   (pristine and polluted, 32 and 2^17) and ``abdul_razzak_ghan_2000``
   (2 x 16 and 2 x 2^16) through their entry points with each JAX test's
   bounds, K3 launches = solves, K3 against its twin on a solve of each
   run;
41. ``arabas_et_al_2025`` at 2^17 (the box and its particles scaled from
   the test's 256), singular and time-dependent at the three cooling
   rates, the four JAX tests' bounds;
42. the seeding parcel at 2^17 + 2^12 graves, 2^12 super-droplets per 100
   s in the 300-400 s window, collisions on: the JAX test's bounds, the
   super-droplet count up by each step's injection until every grave is
   filled, K1 launches = collision substeps and K3 = solves, condensation's
   success; the first K1 substep and K3 solve from t = 330 s (injected
   drops beside graves) against their twins; a 2^17 ``RelaxedVelocity``
   box within rtol 1e-3 of the terminal velocity;
43. ``kreidenweis_et_al_2003.Simulation`` with the default backend at 2^17,
   dt = 1 s and 5 chemistry substeps (``run_convergence_point``'s), over
   the first 400 s of the ascent: the JAX test's bounds at the end, S(VI)
   grown, every aqueous amount and gas row finite, K3 launches = solves,
   the pH kernel's launches (two a substep at least) and K4's counted; one
   more step's first K3 solve and first pH solve, in cloud, against their
   twins (the pH kernel's H to the bit or within ``compare_ph_solves``'
   bound; the pH solve also eight times over, 2^20 drops, each in float32
   and float64 at 0, 1, 47 and 48 iterations), each timed with its twin
   beside its bound (the pH kernel also at 2^20); 3 steps timed
   dynamic by dynamic (the pH kernel launched 10 times a step) and 3 + 3
   profiled (at most ``KW_KERNELS_PER_STEP_MAX`` kernels a step); the pH
   solve as the kernel, its eager twin and the JAX body timed in turns;
43b. the same at 2^10 on the card (float32) and on the CPU (float64) from
   the same initial attributes over 250 s: the largest differences in pH,
   gas S(IV), aqueous S(VI) and liquid water against ``KW_F32_BOUNDS``,
   printed (a miss is a finding, not a failure); the pH kernel's launches
   on the card (none on the CPU);
44. ``jaruga_and_pawlowska_2018.run_convergence_point`` at 2^17, dt = 2
   s, one substep, the whole ascent: the JAX test's bounds, K3 launches =
   solves, the pH kernel's launches (two a step at least), the four
   numbers beside the paper's;
45. every isotope formula on float32 CUDA tensors against float64 within
   ``ISOTOPE_F32_BOUND``, and Rozanski & Sonntag's one-drop parcel
   (``run_parcel``, default backend) over its first 1080 m against a
   float64 CPU run, K3 launches = solves;
46. checkpoint and resume (``pysdm_tpu_torch/utils/checkpoint.py``): the
   box of phase 3 at 2^20 and the full-width warm rain through
   ``make_simulation`` (2 spin-up steps, then collisions and
   sedimentation on) each take 5 steps, ``save_npz`` and 10 more (run
   A); a new build of each, its flags as built, ``restore_npz`` and 10
   steps (run B): every leaf of the sim-state, ``n_steps``, the host
   clock and both generator states equal (``state_differences``), K1's
   launches (the box) and K2's, K3's and K4's (the warm rain) equal over
   the two stretches, each counted with the counts set to 0 just before
   a step and read just after; B's first step's K1 substep, K2
   substep, K3 solve and K4 scans against their twins; the warm rain's
   ``save_dcp`` at step 5 restored into A: every leaf as ``save_npz``
   wrote it; the checkpoints' bytes and the seconds to save and restore;
47. the exporters (``pysdm_tpu_torch/exporters/``) on the card's output:
   three 2D products captured after each of B's 10 steps, written by
   ``NetCDFExporter`` and read back equal to the float32 arrays;
   ``VTKExporter.export_products`` at 625 cells and ``export_attributes``
   of a 25 x 25 x 2^8 warm rain, with their seconds;
48. the SciPy ODE solver (``utils/scipy_ode_condensation_solver.py``)
   against K3: the JAX test's parcel (32 drops, 200 steps) and
   ``pyrcel.Simulation`` at ``TestPyrcel``'s 16 + 16, each with K3 and
   with ``scipy_solver``: T, qv and liquid water within
   ``SCIPY_BOUNDS``, K3's launches = solves on its side and none on the
   SciPy side, the ms/step of each;
49. ``utils/profiling.py``'s ``profile_run`` over 3 steps of B into a
   trace: every dynamic's seconds > 0, every dynamic's scope and K2's,
   K3's and K4's kernels in the trace;
50. the decomposed warm rain (``pysdm_tpu_torch.parallel``) at full width,
   25 x 25 x 2^12 from a haze start, its ranks spawned from here
   (``multihost.spawn``): run A on one rank (NCCL), 10 steps, collisions
   off; runs B and C on ``DIST_RANKS`` x-slabs (NCCL where the host has
   a card a rank, else gloo with CUDA tensors on the one card, chosen
   before the run and printed). B takes A's 10 steps and is held to A:
   dry-volume identities and multiplicities equal, positions and water
   masses within ``DIST_BOUNDS`` on 99.9% of the particles and within
   ``DIST_MAX_BOUNDS`` on all, the global thd, qv and RH within
   ``DIST_BOUNDS``. C spins up 2 steps, then runs 10 with collisions and
   sedimentation on, each counted with K2's, K3's and K4's counts set to
   0 just before it and read just after on every rank (K2 = collision
   substeps, K3 = solves); the water budget within 1e-3, no migration
   dropped or far, condensation succeeding, multiplicities >= 0,
   particles crossing slabs; rank 0's first counted step's K2 substep,
   K3 solve and K4 scans against their twins; C's ms/step on every
   rank's host clock, the bytes the exchanges carry and the particles in
   flight (skipping a collision step) out of those alive. B and A run one
   step at a time, and the fields' largest relative deviation (thd, qv,
   RH) of B from A is printed after each of the 10 steps and held to
   ``DIST_FIELD_STEP_BOUNDS``, step by step (and at step 10 to
   ``DIST_BOUNDS`` too). D, in the same spawn after C: the undersized buffers of
   ``tests/smoke/test_torch_distributed_2d.py`` (the crosswind, seed 29,
   8 super-droplets a cell, migration capacity 4) at ``DIST_OVERFLOW_GRID``
   (a grid the ranks' slabs divide), overlap and collisions on, under
   ``verification.migration_probe``: at every commit of every rank the
   later round ships exactly the stashed leftovers it must (by every row),
   the rest are send drops, the drops of all commits are the
   ``migration_dropped`` counter, multiplicities >= 0, water finite.

Every box phase checks multiplicities >= 0, water mass conserved to 1e-6 and
coalescence having happened. After each phase a line ``phase N: wall X s,
total Y s`` gives its seconds and those since the script began (also
``phase_walls`` in the records' line). Any failure raises, and the script exits
non-zero; without a CUDA device, or without the package beside it, it exits
non-zero before printing any result. The last two lines are one JSON object
of the kernels (K2's, K3's and K4's with their launches in the column's two
timed windows, ``column_launches``, beside those of their main path, and
their largest differences to their twins on the column's inputs,
``column_max_abs_err``; K3's in phase 25, ``spichtinger_launches``, and
its time and bound on phase 23's mixed-phase rows, ``k3_mixed_phase_ms``
and ``k3_mixed_phase_bound_ms``; K2's and K4's launches in phase 22,
``dejong_column_launches``; K1's Geometric time, bound and difference to
its twin from phase 18 and its launches in phase 20, ``berry_launches``;
K5's in phase 21, ``bulenok_launches``; K4's on phase 31's sort croupier,
``straub_sort_launches``; K1a's at Berry's 2^13, its main path's width,
with its 2^20 times and its launches in phase 30's adaptive run, and its
Parameterized form's, ``parameterized_*``, also in an entry of its own,
``coalesce_mirror_parameterized``, with its launches in phase 30's two
runs; K3's per variant set of phase 34, ``variant_sets``,
with the launches on the model path of phases 35-37 that uses each; the
launches on phases 38-42's paths, ``mg2007_launches``,
``bartman_launches``, ``parcel_model_launches`` and ``seeding_launches``,
and the differences to the twins on those paths' inputs, ``*_max_abs_err``;
K3's and K4's on phases 43-45, ``kreidenweis_launches``,
``jaruga_launches``, ``rozanski_launches``; K1's, K2's, K3's and K4's on
phase 46's resumed runs and their differences to their twins there,
``resume_launches`` and ``resume_max_abs_err``, and K3's on phase 48's
parcel, ``scipy_parcel_launches``; the pH kernel's, ``equilibrate_H``,
with its launches in phases 43 and 44, its difference in log H to its
twin on phase 43's in-cloud solve, its time at 2^20 (``ms_2_20``) and the
threads a block of its source (``threads_per_block``); K2's, K3's and K4's launches on phase
50's run C by rank, ``distributed_launches``, and their differences to
their twins there, ``distributed_max_abs_err``), before them one line of
the float64 paths' and the models' records (phases 31-50), and one of the
device.
"""

import concurrent.futures
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

N_MAIN = 2**20
N_STEPS = 100
N_PARCEL = 2**17
PARCEL_STEPS = 1000
# K3's DropSolveSettings on the parcel path: Condensation's defaults
K3_SETTINGS = (1e-6, 1e-7, 16, 64)
K3_ARGS = (
    "water_mass", "vdry", "kappa", "multiplicity", "cell_id", "thd", "qv",
    "rhod", "dt_sub", "active", "rho_air", "mu_air",
)


def gpu_line():
    """the card's name and power limit as nvidia-smi reports them"""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _nvcc_version(nvcc):
    out = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout
    return out.strip().splitlines()[-1]


def _random_state(torch, n, K, ext_dtype, seed, device):
    """multiplicities up to 2^40 with 5% dead slots and 5% ties with the
    partner (K - o) mod n; two extensive rows; float32 volumes"""
    import numpy as np

    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 2**40, size=n).astype(np.int64)
    partner = (K - np.arange(n)) % n
    tie = rng.uniform(size=n) < 0.05
    mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=n) < 0.05] = 0
    ext = rng.uniform(1e-12, 1e-9, size=(2, n)).astype(ext_dtype)
    volume = rng.uniform(1e-15, 1e-12, size=n).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (mult, ext, volume)]


def _time_ms(torch, fn, reps):
    """device milliseconds per call: CUDA events around ``reps`` calls queued
    behind a device-side sleep, so that the host's enqueue time (wrapper,
    allocation, launch) is hidden and the events see only device work"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)  # ~0.2 s at ~2 GHz, longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def k1_args(torch, n, ext_dtype, seed, device):
    """K1's arguments on a random state (``_random_state``), Golovin (its
    one attribute row, the volume), a scale that changes 5-95% of the
    slots"""
    from pysdm_tpu_torch.ops.cuda.collision import GOLOVIN

    K = (n // 3) * 2
    mult, ext, volume = _random_state(torch, n, K, ext_dtype, seed, device)
    scale = torch.tensor([2e-3], dtype=torch.float32, device=device)
    # the collision kernel's attribute rows: Golovin reads the volume
    attr = volume[None, :].contiguous()
    return (mult, ext, attr, GOLOVIN, (1.5e3, 0.0), scale, K, 3141592653)


def check_deterministic(torch, fn, inputs, label):
    """three calls of ``fn`` on the same inputs bit-equal in every output,
    rate sums included; calls on two inputs queued on two streams at once
    (each stream has its own scratch) bit-equal to the calls alone"""
    runs = [fn(*inputs[0]) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        if not all(torch.equal(a, b) for a, b in zip(runs[0], run)):
            raise AssertionError(f"{label}: three runs differ")
    alone = [runs[0], fn(*inputs[1])]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in alone]
    together = []
    for _ in range(10):
        for args, stream in zip(inputs, streams):
            with torch.cuda.stream(stream):
                together.append(fn(*args))
    torch.cuda.synchronize()
    for k, got in enumerate(together):
        if not all(torch.equal(a, b) for a, b in zip(got, alone[k % 2])):
            raise AssertionError(f"{label}: calls on two streams differ")
    print(f"{label}: three runs bit-equal, rate sums included; 10 pairs of"
          f" calls queued on two streams bit-equal to the calls alone")


def _kernel_vs_twin(torch, kern, device, gpu):
    """phase 2; returns (max_abs_err, kernel_ms, twin_ms) at N_MAIN"""
    import numpy as np

    max_abs_err = 0.0
    for n, ext_dtype in ((2**16, np.float32), (2**16, np.float64),
                         (N_MAIN, np.float32)):
        args = k1_args(torch, n, ext_dtype, n, device)
        mult = args[0]
        before = kern.coalesce_mirror.launches
        got = kern.coalesce_mirror(*args)
        torch.cuda.synchronize()
        if kern.coalesce_mirror.launches != before + 1:
            raise AssertionError("launch counter did not count the launch")
        want = kern.coalesce_mirror_reference(*args)
        got = [x.cpu().numpy() for x in got]
        want = [x.cpu().numpy() for x in want]
        np.testing.assert_array_equal(got[0], want[0])
        changed = float((got[0] != mult.cpu().numpy()).mean())
        if not 0.05 < changed < 0.95:
            raise AssertionError(f"update touched {changed} of the slots")
        rtol = 1e-6 if ext_dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got[1], want[1], rtol=rtol)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g, w, rtol=1e-5)
        err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
        if n == N_MAIN:
            max_abs_err = err
        print(f"phase 2: n={n} ext={np.dtype(ext_dtype).name}: xi equal,"
              f" ext max abs err {err!r}, rates {got[2:]} vs {want[2:]}")
    # four inputs of 37 MB each (mult, two float32 rows, volume in; mult
    # and rows out), together past the 50 MB L2
    inputs = [args] + [
        k1_args(torch, N_MAIN, ext_dtype, seed, device) for seed in (1, 2, 3)
    ]
    check_deterministic(torch, kern.coalesce_mirror, inputs[:2], "phase 2: K1")
    kernel_ms = _time_ms(torch, lambda: kern.coalesce_mirror(*args), 200)
    twin_ms = _time_ms(torch, lambda: kern.coalesce_mirror_reference(*args), 10)
    rotated_ms = _time_rotated_ms(
        torch, lambda a: kern.coalesce_mirror(*a), inputs, 200
    )
    print(f"phase 2: n={N_MAIN} kernel {kernel_ms!r} ms on one input (in the"
          f" L2), {rotated_ms!r} ms over a rotation of {len(inputs)} inputs"
          f" (device memory), plain twin {twin_ms!r} ms per substep [{gpu}]")
    return max_abs_err, kernel_ms, twin_ms


def k2_state(n, n_cell, n_ext, ext_dtype, seed):
    """K2's inputs over a cell-sorted state, as numpy rows: n slots in
    n_cell cells of random sizes, 5% dead slots in the trailing bucket,
    multiplicities up to 2^40 with 5% of the pairs tied, kernel-times-norm
    values spread so that the pairs see gamma = 0, gamma capped by
    xi_j / xi_k and exhaustion splits. Returns (mult, ext, kernnorm, rand,
    is_first, cell)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_dead = n // 20
    cell = np.concatenate([
        np.sort(rng.integers(0, n_cell, n - n_dead)), np.full(n_dead, n_cell)
    ])
    start = np.searchsorted(cell, np.arange(n_cell + 1))
    offset = np.arange(n) - start[cell]
    same_as_next = np.append(cell[1:] == cell[:-1], False)
    is_first = same_as_next & (offset % 2 == 0) & (cell < n_cell)
    mult = rng.integers(1, 2**40, size=n).astype(np.int64)
    mult[n - n_dead:] = 0
    leaders = np.flatnonzero(is_first)
    tied = leaders[rng.uniform(size=leaders.size) < 0.05]
    mult[tied + 1] = mult[tied]
    ext = rng.uniform(1e-12, 1e-9, size=(n_ext, n)).astype(ext_dtype)
    kernnorm = (
        rng.lognormal(0.0, 2.0, n) / np.median(mult[: n - n_dead])
    ).astype(np.float32)
    rand = rng.uniform(size=n).astype(np.float32)
    return mult, ext, kernnorm, rand, is_first, cell


def build_box(n_sd, dt, adaptive):
    """``bench.py``'s box (Golovin b = 1.5e3, dv = 1e6 m^3, exponential
    spectrum) on the port's ``GPU`` backend"""
    from pysdm_tpu_torch import Builder, Formulae
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.dynamics import Coalescence
    from pysdm_tpu_torch.dynamics.collisions.collision_kernels import Golovin
    from pysdm_tpu_torch.environments import Box
    from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu_torch.initialisation.spectra import Exponential
    from pysdm_tpu_torch.physics import si

    formulae = Formulae(seed=44)
    builder = Builder(
        n_sd=n_sd, backend=GPU(formulae),
        environment=Box(dv=1e6 * si.m**3, dt=dt * si.s),
    )
    x_0 = float(formulae.trivia.volume(radius=30.531 * si.um))
    builder.add_dynamic(
        Coalescence(collision_kernel=Golovin(b=1.5e3), adaptive=adaptive)
    )
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        Exponential(norm_factor=(2**23) * 1e6, scale=x_0)
    ).sample(n_sd)
    return builder.build(attributes)


def _totals(p):
    """(water mass, droplet count) after checking the state's shape, signs
    and finiteness"""
    import numpy as np

    mult = p.attributes["multiplicity"]
    mass = p.attributes["water mass"]
    if mult.shape != (p.n_sd,) or mass.shape != (p.n_sd,):
        raise AssertionError(f"state shapes {mult.shape}, {mass.shape}")
    if (mult < 0).any():
        raise AssertionError("negative multiplicity")
    if not np.isfinite(mass).all():
        raise AssertionError("non-finite water mass")
    return float((mult * mass).sum()), float(mult.sum())


def _check_conserved(label, before, after):
    (mass0, count0), (mass1, count1) = before, after
    if abs(mass1 - mass0) > 1e-6 * mass0:
        raise AssertionError(f"{label}: water mass {mass0} -> {mass1}")
    if not count1 < count0:
        raise AssertionError(f"{label}: no coalescence ({count0} -> {count1})")


@contextlib.contextmanager
def _replaced(module, name, value):
    """``module.name`` set to ``value`` inside the block: a kernel's wrapper
    replaced by its plain twin where the path calls it (for timing and
    comparison only)"""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _k1_twin_in_place():
    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.ops.cuda.collision import coalesce_mirror_reference

    return _replaced(collision, "coalesce_mirror", coalesce_mirror_reference)


def _main_path(torch, kern, gpu):
    """phase 3; returns the main path's launch count"""
    import numpy as np

    p = build_box(N_MAIN, 1.0, adaptive=False)
    before = _totals(p)
    p.run(1)
    p.block_until_ready()
    kern.coalesce_mirror.launches = 0
    t0 = time.perf_counter()
    p.run(N_STEPS)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = kern.coalesce_mirror.launches
    if launches != N_STEPS:
        raise AssertionError(f"{launches} kernel launches for {N_STEPS} substeps")
    _check_conserved("phase 3", before, _totals(p))
    ms_step = elapsed / N_STEPS * 1e3
    print(f"phase 3: box n_sd={N_MAIN} non-adaptive:"
          f" {N_MAIN / 2 * N_STEPS / elapsed!r}"
          f" pair-updates/s, {ms_step!r} ms/step, {launches} launches [{gpu}]")

    with _k1_twin_in_place():
        n_plain = 10
        t0 = time.perf_counter()
        p.run(n_plain)
        p.block_until_ready()
        plain_ms = (time.perf_counter() - t0) / n_plain * 1e3
    print(f"phase 3: the same step with the plain twin: {plain_ms!r} ms/step"
          f" [{gpu}]")

    # end to end on a small box: the kernel path against the twin path on
    # the same draws (the generator is host-side and seeded alike)
    runs = []
    for use_twin in (False, True):
        small = [build_box(2**16, 1.0, False), build_box(2**16, 10.0, True)]
        with (_k1_twin_in_place() if use_twin else contextlib.nullcontext()):
            for q, steps in zip(small, (5, 3)):
                q.run(steps)
        runs.append([
            (q.attributes["multiplicity"], q.attributes["water mass"])
            for q in small
        ])
    for (mk, wk), (mt, wt) in zip(*runs):
        np.testing.assert_array_equal(mk, mt)
        np.testing.assert_allclose(wk, wt, rtol=1e-6)
    print("phase 3: 2^16 box through kernel and twin: xi equal after 5"
          " non-adaptive and 3 adaptive steps")
    return launches


def _adaptive(kern, gpu):
    p = build_box(N_MAIN, 10.0, adaptive=True)
    before = _totals(p)
    n0 = int(p.get_counter("collision_n_substep")[0])
    kern.coalesce_mirror.launches = 0
    t0 = time.perf_counter()
    p.run(5)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    substeps = int(p.get_counter("collision_n_substep")[0]) - n0
    if kern.coalesce_mirror.launches != substeps or substeps < 5:
        raise AssertionError(
            f"{kern.coalesce_mirror.launches} launches for {substeps} substeps"
        )
    _check_conserved("phase 4", before, _totals(p))
    print(f"phase 4: adaptive box n_sd={N_MAIN} dt=10 s: 5 steps, {substeps}"
          f" substeps, {elapsed / 5 * 1e3!r} ms/step [{gpu}]")


def k3_rows(n, seed=7):
    """K3's inputs for ``n`` drops in five cells, as numpy rows (float32,
    int64 multiplicity, int32 cell id, bool cell activity): cell 0
    supersaturated, its drops growing; cell 1 subsaturated haze, wet radius
    twice the dry (``settle_haze`` brings it to equilibrium); cell 2
    inactive; cell 3 with every third drop dead (multiplicity 0) and every
    third of zero mass; cell 4 with dt_sub = 1e30 under supersaturation,
    which drives the root past x_max, where exp overflows"""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = (n // 4, n // 4, n // 8, n // 8, n - 2 * (n // 4) - 2 * (n // 8))
    cell = np.repeat(np.arange(5), sizes).astype(np.int32)
    r_dry = np.exp(rng.uniform(np.log(2e-8), np.log(2e-7), n))
    r_wet = np.exp(rng.uniform(np.log(1e-6), np.log(20e-6), n))
    r_wet[cell == 1] = 2 * r_dry[cell == 1]
    water_mass = (4 / 3 * np.pi * r_wet**3 * 1e3).astype(np.float32)
    mult = rng.integers(1, 10**9, n).astype(np.int64)
    in_cell_3 = np.flatnonzero(cell == 3)
    mult[in_cell_3[::3]] = 0
    water_mass[in_cell_3[1::3]] = 0
    return {
        "water_mass": water_mass,
        "vdry": (4 / 3 * np.pi * r_dry**3).astype(np.float32),
        "kappa": np.full(n, 0.61, np.float32),
        "multiplicity": mult,
        "cell_id": cell,
        "thd": np.full(5, 290.0, np.float32),
        "qv": np.array([0.013, 7.5e-3, 0.013, 0.013, 0.013], np.float32),
        "rhod": np.full(5, 1.1944, np.float32),
        "dt_sub": np.array([0.5, 0.1, 0.5, 0.5, 1e30], np.float32),
        "active": np.array([True, True, False, True, True]),
        "rho_air": np.full(5, 1.2, np.float32),
        "mu_air": np.full(5, 1.8e-5, np.float32),
    }


def k3_optional(torch, rows, device):
    """the per-drop rows K3 reads only under some variant sets (the organic
    fraction, the Reynolds number), as keyword arguments on ``device``"""
    return {
        k: torch.from_numpy(rows[k]).to(device)
        for k in K3_OPTIONAL if k in rows
    }


def k3_call(fn, formulae, settings, rows, device):
    """``fn`` (K3's wrapper or its twin) on the rows moved to ``device``;
    numpy (mass_new, success)"""
    import torch

    mass, success = fn(
        formulae, settings,
        *(torch.from_numpy(rows[k]).to(device) for k in K3_ARGS),
        **k3_optional(torch, rows, device),
    )
    return mass.cpu().numpy(), success.cpu().numpy()


# phase 34's variant sets: Formulae keyword arguments (constants filled in
# by ``k3_variant_formulae``), and the models that run each
K3_VARIANT_SETS = {
    "a_august_roche_magnus": (
        dict(saturation_vapour_pressure="AugustRocheMagnus"),
        "arabas_and_shima_2017, yang_et_al_2018",
    ),
    "b_grabowski_2011": (
        dict(diffusion_kinetics="GrabowskiEtAl2011",
             diffusion_thermics="GrabowskiEtAl2011",
             constants={"MAC": 0.036, "HAC": 0.7}),
        "jensen_and_nugent_2017",
    ),
    "c_lowe_film": (
        dict(surface_tension="CompressedFilmOvadnevaite"), "lowe_et_al_2019",
    ),
    "d_lowe_constant": (dict(surface_tension="Constant"), "lowe_et_al_2019"),
    "e_ruehl": (dict(surface_tension="CompressedFilmRuehl"), "singer_ward"),
    "f_szyszkowski_langmuir": (
        dict(surface_tension="SzyszkowskiLangmuir"), "singer_ward",
    ),
    "g_froessling": (dict(ventilation="Froessling1938"), None),
    "h_pruppacher_rasmussen": (
        dict(ventilation="PruppacherAndRasmussen1979"), None,
    ),
    # the remaining variants once each, over three sets (one saturation
    # vapour pressure a set)
    "i1_bolton": (
        dict(saturation_vapour_pressure="Bolton1980",
             diffusion_thermics="TracyWelchPorter",
             latent_heat_vapourisation="SeinfeldPandis",
             diffusion_kinetics="PruppacherKlett"),
        None,
    ),
    "i2_murphy_koop": (
        dict(saturation_vapour_pressure="MurphyKoop2005",
             diffusion_thermics="SeinfeldAndPandis2010",
             latent_heat_vapourisation="Constant"),
        None,
    ),
    "i3_wexler": (dict(saturation_vapour_pressure="Wexler1976"), None),
}
K3_OPTIONAL = ("f_org", "reynolds")


def k3_variant_formulae(name):
    """the port's Formulae of phase 34's set ``name``: Lowe et al. 2019's
    (``lowe_et_al_2019.make_formulae``) for c and d, Singer and Ward's
    beta-caryophyllene film constants for e and f"""
    from pysdm_tpu_torch import Formulae

    kwargs = dict(K3_VARIANT_SETS[name][0])
    if name in ("c_lowe_film", "d_lowe_constant"):
        from pysdm_tpu_torch.models import lowe_et_al_2019

        return lowe_et_al_2019.make_formulae(kwargs["surface_tension"])
    if name in ("e_ruehl", "f_szyszkowski_langmuir"):
        from pysdm_tpu_torch.models import singer_ward

        wmv = Formulae().constants.water_molar_volume
        mode = singer_ward.AerosolBetaCaryophylleneDark(wmv).modes[0]
        return singer_ward.make_formulae(kwargs["surface_tension"], mode)
    return Formulae(seed=44, **kwargs)


def k3_variant_rows(name, n, seed):
    """``k3_rows`` for phase 34's set ``name``: with an organic fraction row
    (uniform on [0, 1], every 16th drop 0 and every 17th 1) under a film
    form, with a Reynolds-number row (log-uniform on [1e-3, 30], both sides
    of Pruppacher and Rasmussen's threshold) under ventilation"""
    import numpy as np

    rows = k3_rows(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    kwargs = K3_VARIANT_SETS[name][0]
    if kwargs.get("surface_tension", "Constant") != "Constant":
        f_org = rng.uniform(0, 1, n).astype(np.float32)
        f_org[::16] = 0
        f_org[::17] = 1
        rows["f_org"] = f_org
    if "ventilation" in kwargs:
        rows["reynolds"] = np.exp(
            rng.uniform(np.log(1e-3), np.log(30.0), n)
        ).astype(np.float32)
    return rows


def settle_haze(formulae, rows, device, cell=1, max_rounds=60):
    """iterate the drops of ``cell`` through K3's wrapper (the kernel on a
    CUDA device, the twin on the CPU) until their masses change by less than
    5e-5 in a round: haze at its float32 Koehler equilibrium"""
    import numpy as np

    from pysdm_tpu_torch.ops.condensation import DropSolveSettings
    from pysdm_tpu_torch.ops.cuda import condensation as k3

    rows = dict(rows)
    in_cell = rows["cell_id"] == cell
    for _ in range(max_rounds):
        mass, _ = k3_call(
            k3.masses_new, formulae, DropSolveSettings(*K3_SETTINGS), rows,
            device,
        )
        old = rows["water_mass"]
        change = np.max(np.abs(mass[in_cell] - old[in_cell]) / old[in_cell])
        rows["water_mass"] = np.where(in_cell, mass, old)
        if change < 5e-5:
            return rows
    raise AssertionError("haze did not settle")


def check_k3_regimes(rows, mass, success):
    """what each cell of ``k3_rows`` must give, whatever computed it"""
    import numpy as np

    cell, old = rows["cell_id"], rows["water_mass"]
    # ice (a negative mass, ``k3_rows_with_ice``) is inert in every cell
    growing, haze = (cell == 0) & (old > 0), (cell == 1) & (old > 0)
    inert = (cell == 2) | (rows["multiplicity"] == 0) | (old <= 0)
    non_finite = (cell == 4) & ~inert
    if not (success[growing].all() and (mass[growing] > old[growing]).all()):
        raise AssertionError("K3: the supersaturated drops did not all grow")
    if not success[haze].all():
        raise AssertionError("K3: settled haze failed")
    np.testing.assert_allclose(mass[haze], old[haze], rtol=1e-4)
    if not success[inert].all() or (mass[inert] != old[inert]).any():
        raise AssertionError("K3: an inactive, dead or dry drop changed")
    if success[non_finite].any() or (mass[non_finite] != old[non_finite]).any():
        raise AssertionError("K3: a non-finite root was not refused")


def k3_rows_with_ice(rows, every=4):
    """``rows`` with every ``every``-th drop frozen: its signed mass negated,
    as ``MixedPhaseSpheres`` keeps ice"""
    import numpy as np

    mixed = dict(rows)
    water_mass = rows["water_mass"].copy()
    water_mass[::every] = -np.abs(water_mass[::every])
    mixed["water_mass"] = water_mass
    return mixed


def check_k3_ice(rows, mass, success):
    """every drop of ice (a negative mass) keeps its mass bit for bit and
    counts as solved"""
    ice = rows["water_mass"] < 0
    if not success[ice].all():
        raise AssertionError("K3: a drop of ice failed")
    if (mass[ice].view("u4") != rows["water_mass"][ice].view("u4")).any():
        raise AssertionError("K3: a drop of ice changed")


def compare_k3(rows, kernel, twin, rtol_x):
    """kernel against twin: success equal; where either moved the drop,
    log-mass within 2 rtol_x |x_old| + 2e-5: each stops bisecting inside a
    bracket of width rtol_x |x_old| around the root, an ulp in minfun can
    send the last halvings to either side, and two float32 libms put the
    root itself up to ~1e-5 apart (the twin on the CPU lies within 9e-6 of
    the float64 root); elsewhere equal. Returns the largest absolute and
    relative mass differences."""
    import numpy as np

    (mass_k, ok_k), (mass_t, ok_t) = kernel, twin
    np.testing.assert_array_equal(ok_k, ok_t)
    old = rows["water_mass"]
    moved = (mass_k != old) | (mass_t != old)
    x_old = np.abs(np.log(np.where(old > 0, old, 1e-18).astype(np.float64)))
    dx = np.abs(np.log(mass_k[moved].astype(np.float64))
                - np.log(mass_t[moved].astype(np.float64)))
    if not (dx <= 2 * rtol_x * x_old[moved] + 2e-5).all():
        raise AssertionError(f"K3: log-mass off by {dx.max()!r}")
    np.testing.assert_array_equal(mass_k[~moved], mass_t[~moved])
    diff = np.abs(mass_k.astype(np.float64) - mass_t)
    rel = diff[moved] / mass_t[moved]
    return float(diff.max()), float(rel.max()) if rel.size else 0.0


def k3_uniform_rows(rows, source_cell, active=True):
    """``k3_rows`` made uniform: every drop takes the state of a drop of
    ``source_cell`` and every cell that cell's rows (``active`` for all)"""
    import numpy as np

    n = rows["water_mass"].shape[0]
    take = np.resize(np.flatnonzero(rows["cell_id"] == source_cell), n)
    uniform = {
        k: v[take] if v.shape[0] == n else np.full_like(v, v[source_cell])
        for k, v in rows.items()
    }
    uniform["cell_id"] = rows["cell_id"]
    uniform["active"] = np.full_like(rows["active"], active)
    return uniform


def k3_permuted_rows(rows, seed=3):
    """(rows with the drops in a random order, the order): a block's drops
    then come from every cell, before and after its first drop's, so most
    blocks' threads compute their cells' states themselves"""
    import numpy as np

    n = rows["water_mass"].shape[0]
    order = np.random.default_rng(seed).permutation(n)
    return {
        k: v[order] if v.shape[0] == n else v for k, v in rows.items()
    }, order


def k3_regrouped_rows(rows, n_cell):
    """``k3_rows`` spread over ``n_cell`` cells of equal size, sorted by
    cell: cell c takes the rows of cell c % 5 and drops of that cell"""
    import numpy as np

    n = rows["water_mass"].shape[0]
    cell = (np.arange(n) * n_cell // n).astype(np.int32)
    take = np.empty(n, np.int64)
    for source in range(5):
        slots = np.flatnonzero(cell % 5 == source)
        take[slots] = np.resize(
            np.flatnonzero(rows["cell_id"] == source), slots.size
        )
    regrouped = {
        k: v[take] if v.shape[0] == n else v[np.arange(n_cell) % 5]
        for k, v in rows.items()
    }
    regrouped["cell_id"] = cell
    return regrouped


def k3_evaluations(k3, formulae, settings, args, halving=False, extra=None):
    """minfun evaluations the twin counts on ``args`` (and the optional rows
    ``extra``); ``halving``: with every round of the root search in the
    middle of the bracket"""
    import torch

    from pysdm_tpu_torch.ops import condensation as cond_ops

    stats = {}
    context = (
        _replaced(cond_ops, "_interpolation_fraction",
                  lambda xa, *rest: torch.full_like(xa, 0.5))
        if halving else contextlib.nullcontext()
    )
    with context:
        k3.masses_new_reference(
            formulae, settings, *args, stats=stats, **(extra or {})
        )
    return stats["minfun_evaluations"]


def _k3_vs_twin(torch, k3, device, gpu):
    """phase 5; returns (max_abs_err, {n: (kernel_ms, twin_ms)}, {n: the
    minfun evaluations the rows need})"""
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.ops.condensation import DropSolveSettings

    formulae = Formulae(seed=44)
    settings = DropSolveSettings(*K3_SETTINGS)
    max_abs_err, times, evaluations = 0.0, {}, {}
    for n in (N_PARCEL, N_MAIN):
        rows = settle_haze(formulae, k3_rows(n, seed=n), device)
        before = k3.masses_new.launches
        kernel = k3_call(k3.masses_new, formulae, settings, rows, device)
        if k3.masses_new.launches != before + 1:
            raise AssertionError("K3's counter did not count the launch")
        twin = k3_call(
            k3.masses_new_reference, formulae, settings, rows, device
        )
        check_k3_regimes(rows, *kernel)
        check_k3_regimes(rows, *twin)
        abs_err, rel_err = compare_k3(rows, kernel, twin, settings.rtol_x)
        max_abs_err = max(max_abs_err, abs_err)
        # the same drops in a random order: the blocks whose drops do not lie
        # within eight cells of the first one's take the per-thread cell
        # state, which must give every drop the bits of the shared one
        permuted, order = k3_permuted_rows(rows)
        shuffled = k3_call(k3.masses_new, formulae, settings, permuted, device)
        for got, want in zip(shuffled, kernel):
            if (got != want[order]).any():
                raise AssertionError("K3: a drop's result depends on its block")
        compare_k3(
            permuted, shuffled,
            k3_call(k3.masses_new_reference, formulae, settings, permuted, device),
            settings.rtol_x,
        )
        args = [torch.from_numpy(rows[k]).to(device) for k in K3_ARGS]
        evaluations[n] = k3_evaluations(k3, formulae, settings, args)
        times[n] = (
            _time_ms(torch, lambda: k3.masses_new(formulae, settings, *args), 50),
            _time_ms(
                torch,
                lambda: k3.masses_new_reference(formulae, settings, *args), 3,
            ),
        )
        bound = bound_ms(n * 29, evaluations[n] * K3_OPS_PER_MINFUN)
        print(f"phase 5: K3 n={n}: success equal, mass max abs diff"
              f" {abs_err!r} kg, max rel diff {rel_err!r}, and the drops in"
              f" a random order bit-equal to the sorted ones; kernel"
              f" {times[n][0]!r} ms, plain twin {times[n][1]!r} ms; the rows"
              f" need {evaluations[n]} minfun evaluations"
              f" ({evaluations[n] / n!r} per drop), bound {bound[0]!r} ms"
              f" ({bound[1]}) [{gpu}]")
        if n != N_PARCEL:
            continue
        halving = k3_evaluations(k3, formulae, settings, args, halving=True)
        print(f"phase 5: K3 n={n}: plain halving would need {halving} minfun"
              f" evaluations ({halving / n!r} per drop)")
        for name, source_cell, active in (
            ("every drop growing", 0, True),
            ("every drop haze at equilibrium", 1, True),
            ("every cell inactive", 0, False),
        ):
            uniform = k3_uniform_rows(rows, source_cell, active)
            u_args = [torch.from_numpy(uniform[k]).to(device) for k in K3_ARGS]
            kernel = k3_call(k3.masses_new, formulae, settings, uniform, device)
            twin = k3_call(
                k3.masses_new_reference, formulae, settings, uniform, device
            )
            compare_k3(uniform, kernel, twin, settings.rtol_x)
            count = k3_evaluations(k3, formulae, settings, u_args)
            ms = _time_ms(
                torch, lambda: k3.masses_new(formulae, settings, *u_args), 50
            )
            print(f"phase 5: K3 n={n}, {name}: kernel {ms!r} ms,"
                  f" {count / n!r} minfun evaluations per drop [{gpu}]")
    return max_abs_err, times, evaluations


def build_parcel(n_sd, backend, adaptive, qv0=0.0158):
    """``bench.py``'s parcel (BASELINE config #3: p0 = 1000 hPa, T0 = 300 K,
    w = 2 m/s, lognormal dry spectrum, kappa = 0.5) on the port's ``backend``
    class"""
    from pysdm_tpu_torch import Builder, Formulae
    from pysdm_tpu_torch.dynamics import AmbientThermodynamics, Condensation
    from pysdm_tpu_torch.environments import Parcel
    from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu_torch.initialisation.spectra import Lognormal

    formulae = Formulae(seed=44)
    env = Parcel(
        dt=1.0, mass_of_dry_air=1e3, p0=1000e2,
        initial_water_vapour_mixing_ratio=qv0, T0=300.0, w=2.0,
    )
    builder = Builder(n_sd=n_sd, backend=backend(formulae), environment=env)
    builder.add_dynamic(AmbientThermodynamics())
    builder.add_dynamic(Condensation(adaptive=adaptive))
    spectrum = Lognormal(norm_factor=1e8 * 1e3, m_mode=50e-9, s_geom=1.5)
    r_dry, n_in_dv = ConstantMultiplicity(spectrum).sample(n_sd)
    attributes = env.init_attributes(n_in_dv=n_in_dv, kappa=0.5, r_dry=r_dry)
    return builder.build(attributes)


def _liquid(p):
    """liquid water mixing ratio (kg/kg) in float64"""
    mult = p.attributes["multiplicity"].astype(float)
    return float((mult * p.attributes["water mass"]).sum()) / float(
        p.get_env("m_d")[0]
    )


def _parcel_main_path(k3, gpu):
    """phase 6; returns (K3 launches, ms/step)"""
    import numpy as np

    from pysdm_tpu_torch.backends import GPU

    p = build_parcel(N_PARCEL, GPU, adaptive=True)
    water0 = float(p.get_env("qv")[0]) + _liquid(p)
    p.run(1)
    p.block_until_ready()
    solver = p.dynamics["Condensation"].solver
    k3.masses_new.launches = 0
    solves0, reads0 = solver.substep_solves, solver.host_reads
    t0 = time.perf_counter()
    p.run(N_STEPS)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = k3.masses_new.launches
    solves = solver.substep_solves - solves0
    if launches != solves or launches < N_STEPS:
        raise AssertionError(f"{launches} K3 launches for {solves} solves")
    ms_step = elapsed / N_STEPS * 1e3
    print(f"phase 6: parcel n_sd={N_PARCEL} adaptive: {N_PARCEL * N_STEPS / elapsed!r}"
          f" droplet-steps/s, {ms_step!r} ms/step, {launches} K3 launches"
          f" ({launches / N_STEPS!r}/step), host reads"
          f" {(solver.host_reads - reads0) / N_STEPS!r}/step [{gpu}]")

    p.run(PARCEL_STEPS - N_STEPS - 1)
    p.block_until_ready()
    if not p.get_counter("condensation_success").all():
        raise AssertionError("parcel: condensation failed")
    RH_max = float(p.get_counter("condensation_RH_max")[0])
    liquid = _liquid(p)
    qv = float(p.get_env("qv")[0])
    mean_r = float(np.mean(p.attributes["radius"].astype(float)))
    drift = (qv + liquid - water0) / water0
    print(f"phase 6: after {PARCEL_STEPS} steps (z = {float(p.get_env('z')[0])!r}"
          f" m): RH_max {RH_max!r}, liquid {liquid!r} kg/kg, qv {qv!r},"
          f" mean radius {mean_r!r} m, total water drift {drift!r}")
    if not 1.0005 < RH_max < 1.05:
        raise AssertionError(f"parcel: RH_max {RH_max}")
    if not liquid > 1e-4:
        raise AssertionError(f"parcel: liquid water {liquid}")
    if not 5e-6 < mean_r < 50e-6:
        raise AssertionError(f"parcel: mean radius {mean_r}")
    # float32 state: qv is rounded at ~6e-10 kg/kg per substep and the
    # liquid sum over 2^17 drops at ~1e-7 of itself
    if not abs(drift) < 1e-4:
        raise AssertionError(f"parcel: total water drifted by {drift}")

    # kernel and twin over the same stretch of cloud, 10 steps each
    in_cloud_ms = []
    twin = _replaced(k3, "masses_new", k3.masses_new_reference)
    for context in (contextlib.nullcontext(), twin):
        with context:
            t0 = time.perf_counter()
            p.run(10)
            p.block_until_ready()
            in_cloud_ms.append((time.perf_counter() - t0) / 10 * 1e3)
    print(f"phase 6: in cloud, steps {PARCEL_STEPS}-{PARCEL_STEPS + 20}:"
          f" {in_cloud_ms[0]!r} ms/step through K3, {in_cloud_ms[1]!r}"
          f" ms/step with the plain twin in its place [{gpu}]")
    return launches, ms_step


def _parcel_gpu_vs_cpu(k3):
    """phase 7: float32 through K3 on the card against the CPU float64
    backend (the bounds of the JAX package's fused-kernel test)"""
    import numpy as np

    from pysdm_tpu_torch.backends import CPU, GPU

    # adaptive from qv0 = 0.0225 is not compared: float32 and float64 pick
    # different substep counts through activation (2.8e-3 apart in a CPU
    # float32 run)
    for qv0, adaptive in ((0.0158, False), (0.0158, True), (0.0225, False)):
        before = k3.masses_new.launches
        on_card, on_cpu = (
            build_parcel(64, b, adaptive, qv0=qv0) for b in (GPU, CPU)
        )
        on_card.run(50)
        on_cpu.run(50)
        if k3.masses_new.launches == before:
            raise AssertionError("phase 7: the card's run did not launch K3")
        for q in (on_card, on_cpu):
            if not q.get_counter("condensation_success").all():
                raise AssertionError("phase 7: condensation failed")
        np.testing.assert_allclose(
            on_card.attributes["water mass"], on_cpu.attributes["water mass"],
            rtol=2e-3,
        )
        np.testing.assert_allclose(
            on_card.get_env("qv"), on_cpu.get_env("qv"), rtol=1e-4
        )
        err = np.max(np.abs(
            on_card.attributes["water mass"] / on_cpu.attributes["water mass"]
            - 1
        ))
        print(f"phase 7: 64 drops, 50 steps, qv0={qv0}, adaptive={adaptive}:"
              f" RH_max {float(on_cpu.get_counter('condensation_RH_max')[0])!r},"
              f" water mass max rel diff {err!r}, qv"
              f" {on_card.get_env('qv')[0]!r} vs"
              f" {on_cpu.get_env('qv')[0]!r}")



# the card's published rates (NVIDIA H100 SXM data sheet, at 700 W): device
# memory bytes/s and dense float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations charged to one minfun evaluation in K3's bound: the
# count of its first formulation (exp, cube root, the Koehler and Fick
# terms, the log-coordinate derivative: ~20 multiply-adds, ~8 divisions, 4
# transcendental calls, each counted as one operation), kept so that the
# bounds of all slices compare; the kernel now runs fewer
K3_OPS_PER_MINFUN = 60
WARM_RAIN_GRID = (25, 25)
WARM_RAIN_SD_PER_CELL = 2**12
WARM_RAIN_STEPS = 30


def bound_ms(n_bytes, n_ops=0.0):
    """(least time on the card in ms, what sets it): the larger of the
    bytes over the memory rate and the operations over the float32 rate"""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_rotated_ms(torch, fn, inputs, reps):
    """``_time_ms`` of ``fn(x)`` with x taken in turn from ``inputs``, which
    together exceed the L2, so that every call reads device memory"""
    state = {"k": 0}

    def call():
        state["k"] += 1
        return fn(inputs[state["k"] % len(inputs)])

    return _time_ms(torch, call, reps)


def _k4_vs_twin(torch, scan, device, gpu):
    """phase 8: K4 against torch.cumsum and float64; returns (max_abs_err,
    kernel_ms, twin_ms, n) for float32 at 2.56 M, on one input"""
    import numpy as np

    n_main = WARM_RAIN_GRID[0] * WARM_RAIN_GRID[1] * WARM_RAIN_SD_PER_CELL
    max_abs_err = 0.0
    for n in (2**20, n_main, n_main + 12345, 1000, 1):
        rng = np.random.default_rng(n)
        for dtype in (torch.int32, torch.int64):
            x = torch.from_numpy(rng.integers(-1000, 1000, n)).to(dtype).to(device)
            got = scan.cumsum(x)
            if not torch.equal(got, scan.cumsum_reference(x)):
                raise AssertionError(f"K4 {dtype} n={n}: not exact")
        x_np = rng.uniform(size=n).astype(np.float32)
        x = torch.from_numpy(x_np).to(device)
        before = scan.cumsum.launches, scan.cumsum.rows
        runs = [scan.cumsum(x) for _ in range(3)]
        torch.cuda.synchronize()
        if (scan.cumsum.launches, scan.cumsum.rows) != (before[0] + 3, before[1] + 3):
            raise AssertionError("K4's counters did not count the launches")
        if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])):
            raise AssertionError("K4: three runs differ")
        exact = np.cumsum(x_np.astype(np.float64))
        err = np.abs(runs[0].cpu().numpy() - exact)
        twin_err = np.abs(scan.cumsum_reference(x).cpu().numpy() - exact)
        # a chain of at most ~40 roundings of 2^-24 of the prefix each
        if not (err <= 1e-5 * exact).all():
            raise AssertionError(f"K4 f32 n={n}: rel err {np.max(err / exact)!r}")
        if n == n_main:
            max_abs_err = float(err.max())
        # four rows in one launch (rows 1-3 of an odd n are not 16-byte
        # aligned), each bit-equal to its own scan
        rows_np = np.stack([x_np, *rng.uniform(size=(3, n)).astype(np.float32)])
        rows = torch.from_numpy(rows_np).to(device)
        before = scan.cumsum.launches, scan.cumsum.rows
        got = scan.cumsum(rows)
        if (scan.cumsum.launches, scan.cumsum.rows) != (before[0] + 1, before[1] + 4):
            raise AssertionError("K4's counters did not count the rows")
        if not torch.equal(got[0], runs[0]) or not all(
            torch.equal(got[r], scan.cumsum(rows[r])) for r in (1, 2, 3)
        ):
            raise AssertionError(f"K4 n={n}: a row of (4, n) is not its 1D scan")
        print(f"phase 8: K4 n={n}: int32 and int64 exact, float32 max rel"
              f" err {float(np.max(err / exact))!r} (torch.cumsum"
              f" {float(np.max(twin_err / exact))!r}), three runs and the"
              f" rows of a (4, n) call bit-equal")

    rng = np.random.default_rng(0)
    inputs = [
        torch.from_numpy(rng.uniform(size=n_main).astype(np.float32)).to(device)
        for _ in range(8)
    ]
    # two scans in flight at once, each on its own stream with its own flags
    alone = [scan.cumsum(x) for x in inputs[:2]]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in alone]
    together = []
    for _ in range(20):
        for x, stream in zip(inputs[:2], streams):
            with torch.cuda.stream(stream):
                together.append(scan.cumsum(x))
    torch.cuda.synchronize()
    if not all(torch.equal(got, alone[k % 2]) for k, got in enumerate(together)):
        raise AssertionError("K4: scans on two streams differ from scans alone")
    print("phase 8: K4: 20 pairs of scans queued on two streams bit-equal to"
          " the scans alone")

    x = inputs[0]
    stacked = [torch.stack(inputs[k : k + 4]) for k in (0, 4)]
    kernel_ms = _time_ms(torch, lambda: scan.cumsum(x), 200)
    twin_ms = _time_ms(torch, lambda: scan.cumsum_reference(x), 200)
    rows_ms = _time_ms(torch, lambda: scan.cumsum(stacked[0]), 100)
    kernel_cold = _time_rotated_ms(torch, scan.cumsum, inputs, 200)
    twin_cold = _time_rotated_ms(torch, scan.cumsum_reference, inputs, 200)
    rows_cold = _time_rotated_ms(torch, scan.cumsum, stacked, 100)
    rows_twin = _time_rotated_ms(torch, scan.cumsum_reference, stacked, 100)
    print(f"phase 8: K4 n={n_main} float32, one input (in the L2): kernel"
          f" {kernel_ms!r} ms, torch.cumsum {twin_ms!r} ms, a (4, n) call"
          f" {rows_ms!r} ms; over a rotation of 8 inputs (device memory):"
          f" kernel {kernel_cold!r} ms, torch.cumsum {twin_cold!r} ms; (4, n)"
          f" over a rotation of 2: kernel {rows_cold!r} ms, torch.cumsum"
          f" {rows_twin!r} ms [{gpu}]")
    return max_abs_err, kernel_ms, twin_ms, n_main


def _k2_vs_twin(torch, kern, device, gpu):
    """phase 9: K2 against its twin at the warm rain's size, three float32
    rows; returns (max_abs_err, kernel_ms, twin_ms, bytes)"""
    import numpy as np

    n = WARM_RAIN_GRID[0] * WARM_RAIN_GRID[1] * WARM_RAIN_SD_PER_CELL
    state = k2_state(n, WARM_RAIN_GRID[0] * WARM_RAIN_GRID[1], 3, np.float32, 9)
    args = [torch.from_numpy(a).to(device) for a in state[:5]]
    before = kern.coalesce_adjacent.launches
    got = kern.coalesce_adjacent(*args)
    torch.cuda.synchronize()
    if kern.coalesce_adjacent.launches != before + 1:
        raise AssertionError("K2's counter did not count the launch")
    want = kern.coalesce_adjacent_reference(*args)
    got = [x.cpu().numpy() for x in got]
    want = [x.cpu().numpy() for x in want]
    np.testing.assert_array_equal(got[0], want[0])
    changed = float((got[0] != state[0]).mean())
    if not 0.05 < changed < 0.95:
        raise AssertionError(f"K2 touched {changed} of the slots")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
    kernel_ms = _time_ms(torch, lambda: kern.coalesce_adjacent(*args), 200)
    twin_ms = _time_ms(torch, lambda: kern.coalesce_adjacent_reference(*args), 20)
    # each input read once, each output written once: mult 8, three rows
    # 12, kernnorm 4, rand 4, is_first 1 in; mult 8, rows 12, rate and
    # deficit 8 out
    n_bytes = n * (8 + 12 + 4 + 4 + 1 + 8 + 12 + 8)
    print(f"phase 9: K2 n={n} R=3: xi equal ({changed!r} of the slots"
          f" changed), ext max abs err {err!r}; kernel {kernel_ms!r} ms,"
          f" plain twin {twin_ms!r} ms [{gpu}]")
    return err, kernel_ms, twin_ms, n_bytes


def warm_rain(backend, grid, n_sd_per_gridbox, seed=44, spin_up_time=0.0,
              products=()):
    """config #5, the Arabas et al. 2015 2D warm rain, through the port's
    entry point; ``backend`` None takes make_simulation's default (the
    card)"""
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.models import arabas_et_al_2015 as model

    settings = model.Settings(
        Formulae(seed=seed), grid=grid, size=(1500.0, 1500.0),
        n_sd_per_gridbox=n_sd_per_gridbox, spin_up_time=spin_up_time,
    )
    kwargs = {} if backend is None else {"backend_class": backend}
    particulator, spin_up = model.make_simulation(
        settings, products=products, **kwargs
    )
    return settings, particulator, spin_up


def total_water(p):
    """vapour, liquid and this step's precipitation, kg (float64), after
    checking multiplicities and masses"""
    import numpy as np

    mult = p.attributes["multiplicity"]
    mass = p.attributes["water mass"]
    if (mult < 0).any():
        raise AssertionError("negative multiplicity")
    if not np.isfinite(mass).all():
        raise AssertionError("non-finite water mass")
    vapour = float(np.sum(
        p.get_env("rhod").astype(float) * p.get_env("qv") * p.mesh.dv
    ))
    liquid = float(np.sum(mult.astype(float) * mass))
    return vapour + liquid + float(np.sum(p.get_counter("precipitated_mass")))


def _host_reads(p):
    return (
        p.dynamics["Collision"].host_reads
        + p.dynamics["Displacement"].host_reads
        + p.dynamics["Condensation"].solver.host_reads
    )


def _warm_rain_main_path(kern, k3, scan, gpu):
    """phase 10: the full-width warm rain on the card; returns (launches
    per kernel, the particulator, ms/step)"""
    import numpy as np

    _, p, spin_up = warm_rain(None, WARM_RAIN_GRID, WARM_RAIN_SD_PER_CELL)
    if p.device.type != "cuda":
        raise AssertionError(f"make_simulation built on {p.device}")
    spin_up.finish()
    p.run(1)
    p.block_until_ready()
    water0 = total_water(p)
    collision = p.dynamics["Collision"]
    substeps0, reads0 = collision.substeps_run, _host_reads(p)
    solves0 = p.dynamics["Condensation"].solver.substep_solves
    kern.coalesce_adjacent.launches = 0
    k3.masses_new.launches = 0
    scan.cumsum.launches = 0
    scan.cumsum.rows = 0
    t0 = time.perf_counter()
    p.run(WARM_RAIN_STEPS)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = {
        "coalesce_adjacent": kern.coalesce_adjacent.launches,
        "masses_new": k3.masses_new.launches,
        "cumsum": scan.cumsum.launches,
    }
    substeps = collision.substeps_run - substeps0
    solves = p.dynamics["Condensation"].solver.substep_solves - solves0
    if launches["coalesce_adjacent"] != substeps or substeps < WARM_RAIN_STEPS:
        raise AssertionError(f"{launches} for {substeps} collision substeps")
    if launches["masses_new"] != solves or launches["cumsum"] == 0:
        raise AssertionError(f"{launches} for {solves} condensation solves")
    if not p.get_counter("condensation_success").all():
        raise AssertionError("warm rain: condensation failed")
    drift = (total_water(p) - water0) / water0
    if not abs(drift) < 1e-3:
        raise AssertionError(f"warm rain: total water drifted by {drift}")
    ms_step = elapsed / WARM_RAIN_STEPS * 1e3
    n_cell = p.mesh.n_cell
    per_step = {k: v / WARM_RAIN_STEPS for k, v in launches.items()}
    per_step["cumsum rows"] = scan.cumsum.rows / WARM_RAIN_STEPS
    print(f"phase 10: warm rain {WARM_RAIN_GRID} x {WARM_RAIN_SD_PER_CELL}"
          f" ({p.n_sd} super-droplets), {WARM_RAIN_STEPS} steps after one:"
          f" {ms_step!r} ms/step, {n_cell * WARM_RAIN_STEPS / elapsed!r} grid"
          f" points/s, {p.n_sd / 2 * substeps / elapsed!r} pair-updates/s;"
          f" launches per step {per_step}, collision substeps"
          f" {substeps / WARM_RAIN_STEPS!r}/step, condensation solves"
          f" {solves / WARM_RAIN_STEPS!r}/step, host reads"
          f" {(_host_reads(p) - reads0) / WARM_RAIN_STEPS!r}/step; total"
          f" water drift {drift!r}; coalescence rate"
          f" {float(p.get_counter('coalescence_rate').sum())!r} [{gpu}]")
    return launches, p, ms_step


def compare_k3_near_saturation(formulae, settings, rows, kernel, twin_of):
    """kernel against twin where compare_k3's bound cannot hold: in cells
    within ~1e-3 of saturation a drop's growth goes with RH - RH_eq, so its
    new log-mass moves by ~4e3 per unit of RH, and two float32 evaluations
    of RH (T through a power, pvs through an 8th-degree polynomial) lie up
    to 4e-6 apart (each within 2e-6 of the float64 value), which puts
    kernel, twin on the card and twin on the CPU up to 5e-3 apart in
    log-mass, each as far from the float64 root. So: success equal, and
    every drop's log-mass between the twin's results with the cells'
    vapour content 32 float32 ulps (3.8e-6) lower and higher, widened by
    compare_k3's 2 rtol_x |x_old| + 2e-5. At a drop about to activate the
    interval is wide, whatever computes it. ``rows``: K3's tensors;
    ``twin_of(rows)``: the twin's (mass, success), in the rows' dtype.
    Returns what was seen: the largest absolute mass and log-mass
    differences to the twin on the rows as they are, the kernel's and the
    twin's largest log-mass distance from the twin in float64, how many
    drops have an interval wider than 0.02, and the largest distance of a
    cell's float32 RH from its float64 one."""
    import torch

    from pysdm_tpu_torch.ops.condensation import thermo

    def log_mass(mass):
        return torch.log(mass.double().clamp_min(1e-300))

    def relative_humidity(dtype):
        thd, qv, rhod, _, _, rho_air, mu_air = (
            r.to(dtype) for r in rows[5:]
        )
        return thermo(formulae, thd, qv, rhod, rho_air, mu_air)[2]

    (mass_k, ok_k), (mass_t, ok_t) = kernel, twin_of(rows)
    if not torch.equal(ok_k, ok_t):
        raise AssertionError("K3: success differs from the twin's")
    qv = K3_ARGS.index("qv")
    step = 32 * torch.finfo(torch.float32).eps
    ends = [
        log_mass(twin_of([*rows[:qv], rows[qv] * factor, *rows[qv + 1:]])[0])
        for factor in (1 - step, 1 + step)
    ]
    old = rows[0]
    tol = 2 * settings.rtol_x * log_mass(old.clamp_min(1e-18)).abs() + 2e-5
    low = torch.minimum(*ends) - tol
    high = torch.maximum(*ends) + tol
    x_k = log_mass(mass_k)
    outside = (old > 0) & ((x_k < low) | (x_k > high))
    if outside.any():
        worst = torch.maximum(low - x_k, x_k - high)[outside].max()
        raise AssertionError(
            f"K3: {int(outside.sum())} drops outside the twin's interval, by"
            f" up to {float(worst)!r} in log-mass"
        )
    mass_64, ok_64 = twin_of(
        [r.double() if r.is_floating_point() else r for r in rows]
    )
    solved = (old > 0) & ok_64
    return {
        "mass": float((mass_k.double() - mass_t.double()).abs().max()),
        "log-mass": float((x_k - log_mass(mass_t)).abs()[old > 0].max()),
        "kernel to float64": float(
            (x_k - log_mass(mass_64)).abs()[solved].max()
        ),
        "twin to float64": float(
            (log_mass(mass_t) - log_mass(mass_64)).abs()[solved].max()
        ),
        "wide intervals": int(((high - low)[old > 0] > 0.02).sum()),
        "RH float32 to float64": float(
            (relative_humidity(torch.float32).double()
             - relative_humidity(torch.float64)).abs().max()
        ),
    }


def _k3_on_a_warm_rain_solve(torch, p, k3, gpu):
    """phase 10, after the counted steps: one more step whose first
    condensation solve is captured; on that solve's inputs (2.56 M drops
    sorted into 625 cells, many of them near saturation) K3 on the drops in
    a random order bit-equal to K3 on the sorted ones (a block's shared
    cell states against per-thread ones), K3 against its twin
    (``compare_k3_near_saturation``), then K3's time, its minfun
    evaluations (counted by the twin) and its bound; returns the largest
    absolute mass difference to the twin"""
    captured = []
    real = k3.masses_new

    def capturing(*args):
        if not captured:
            captured.append(args)
        return real(*args)

    capturing.launches = 0
    with _replaced(k3, "masses_new", capturing):
        p.run(1)
        p.block_until_ready()
    formulae, settings, *rows = captured[0]
    n = rows[0].shape[0]
    active = int((rows[9][rows[4].long()] & (rows[3] > 0) & (rows[0] > 0)).sum())
    kernel = real(formulae, settings, *rows)
    order = torch.randperm(
        n, generator=torch.Generator(rows[0].device).manual_seed(3),
        device=rows[0].device,
    )
    shuffled = real(
        formulae, settings,
        *(r[order] if r.shape[0] == n else r for r in rows),
    )
    for got, want in zip(shuffled, kernel):
        if not torch.equal(got, want[order]):
            raise AssertionError("K3: a drop's result depends on its block")

    def twin_of(rows):
        return k3.masses_new_reference(formulae, settings, *rows)

    seen = compare_k3_near_saturation(
        formulae, settings, rows, kernel, twin_of
    )
    count = k3_evaluations(k3, formulae, settings, rows)
    ms = _time_ms(torch, lambda: real(formulae, settings, *rows), 50)
    bound = bound_ms(n * 29, count * K3_OPS_PER_MINFUN)
    print(f"phase 10: K3 on the first solve of a warm-rain step ({n} drops"
          f" in {rows[5].shape[0]} cells, {active} of them active): the drops"
          f" in a random order bit-equal to the sorted ones; success equal"
          f" to the twin's and every log-mass inside the twin's interval for"
          f" +-32 ulps of qv; largest differences {seen}; kernel {ms!r} ms;"
          f" {count} minfun evaluations"
          f" ({count / n!r} per drop), bound {bound[0]!r} ms ({bound[1]})"
          f" [{gpu}]")
    return seen["mass"]


def _percell_sums_vs_float64(p):
    """K4 per-cell sums of the main path's liquid water (the condensation
    coupling's ml) against float64 sums of the same float32 values"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.ops import segments

    particles = p.particles
    n_cell = p.mesh.n_cell
    cell_start = segments.cell_start_of_sorted(particles.cell_id, n_cell)
    mass = particles.ext("signed water mass")
    values = torch.where(
        mass > 0, particles.multiplicity.to(mass.dtype) * mass, 0.0
    )
    sums = segments.sorted_segment_sum(values, cell_start, n_cell).cpu().numpy()
    exact = np.bincount(
        particles.cell_id.cpu().numpy(),
        weights=values.cpu().numpy().astype(np.float64), minlength=n_cell,
    )
    rel = np.abs(sums - exact) / exact
    prefix = np.cumsum(exact)
    print(f"phase 10: K4 per-cell liquid sums against float64: max rel err"
          f" {float(rel.max())!r} of the cell's sum, median"
          f" {float(np.median(rel))!r}; max {float(np.max(np.abs(sums - exact) / prefix))!r}"
          f" of the prefix")


def _warm_rain_scenario_on_card(gpu):
    """phase 11: ``tests/smoke/test_kinematic_2d.py`` on the card, then the
    float32 card spin-up against the CPU float64 one"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.backends import CPU

    settings, p, spin_up = warm_rain(None, (8, 8), 16, seed=13,
                                     spin_up_time=300.0)
    w0 = total_water(p)
    lwc0 = float(np.sum(p.attributes["multiplicity"] * p.attributes["water mass"]))
    p.run(settings.n_spin_up)
    rh = p.get_env("RH").reshape(settings.grid)
    lwc1 = float(np.sum(p.attributes["multiplicity"] * p.attributes["water mass"]))
    spin_drift = (total_water(p) - w0) / w0
    if not (p.get_counter("condensation_success").all()
            and np.isfinite(rh).all() and rh.max() < 1.10
            and rh[:, -3:].max() > 0.99 and rh[:, :2].max() < 0.95
            and lwc1 > 5 * lwc0 and abs(spin_drift) < 1e-3):
        raise AssertionError(
            f"spin-up: RH max {rh.max()}, top {rh[:, -3:].max()}, bottom"
            f" {rh[:, :2].max()}, lwc {lwc0} -> {lwc1}, drift {spin_drift}"
        )
    spin_up.finish()
    w1 = total_water(p)
    p.run(120)
    rain_drift = (total_water(p) - w1) / w1
    alive = p.attributes["multiplicity"] > 0
    r_max = float(p.attributes["radius"][alive].max())
    coal = float(p.get_counter("coalescence_rate").sum())
    if not (p.get_counter("condensation_success").all() and coal > 0
            and abs(rain_drift) < 1e-3 and r_max > 1e-6):
        raise AssertionError(
            f"rain: coalescence {coal}, drift {rain_drift}, r_max {r_max}"
        )
    print(f"phase 11: 8x8 x 16 on the card: after the 5 min spin-up RH max"
          f" {float(rh.max())!r}, liquid x{lwc1 / lwc0!r}, water drift"
          f" {spin_drift!r}; after 10 min of rain coalescence rate {coal!r},"
          f" largest radius {r_max!r} m, water drift {rain_drift!r} [{gpu}]")

    # the card (float32, K3) against the CPU float64 backend over 20 spin-up
    # steps, with a CPU float32 run as the yardstick: through activation
    # (RH up to ~1.2 in the top cells) float32 alone moves single drops by
    # up to ~12% (the Richardson floor 16 eps picks other substep counts),
    # so the card must stay as close to float64 as float32 on the CPU does
    from pysdm_tpu_torch.backends import TorchBackend

    class CPU32(TorchBackend):
        def __init__(self, formulae=None):
            super().__init__(formulae, torch.float32, "cpu")

    runs = [warm_rain(b, (8, 8), 16, spin_up_time=3600.0)[1]
            for b in (None, CPU32, CPU)]
    for q in runs:
        q.run(20)
    on_card, cpu32, cpu64 = runs
    np.testing.assert_array_equal(
        on_card.attributes["cell id"], cpu64.attributes["cell id"]
    )

    def gaps(q):
        mass = np.abs(q.attributes["water mass"] / cpu64.attributes["water mass"] - 1)
        return (float(np.max(np.abs(q.get_env("qv") / cpu64.get_env("qv") - 1))),
                float(mass.max()), float(np.median(mass)))

    (qv_err, mass_err, mass_median), yardstick = gaps(on_card), gaps(cpu32)
    if not (qv_err < 1e-4 and mass_err < 1.5 * yardstick[1] + 2e-3
            and mass_median < 2e-3):
        raise AssertionError(
            f"card f32 vs CPU f64: qv {qv_err}, mass {mass_err} (median"
            f" {mass_median}); CPU f32 vs f64: {yardstick}"
        )
    print(f"phase 11: 20 spin-up steps against CPU float64: card float32 qv"
          f" max rel diff {qv_err!r}, water mass max rel diff {mass_err!r}"
          f" (median {mass_median!r}); CPU float32 {yardstick[0]!r},"
          f" {yardstick[1]!r} (median {yardstick[2]!r})")


def _warm_rain_with_twins(p, gpu):
    """phase 12 (timing only): the main path's step with K2's and K4's
    twins in their places"""
    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.ops import segments
    from pysdm_tpu_torch.ops.cuda.collision import coalesce_adjacent_reference
    from pysdm_tpu_torch.ops.cuda.scan import cumsum_reference

    steps = 5
    times = []
    for twins in (False, True):
        contexts = (
            [_replaced(collision, "coalesce_adjacent", coalesce_adjacent_reference),
             _replaced(segments, "cumsum", cumsum_reference)]
            if twins else []
        )
        with contextlib.ExitStack() as stack:
            for c in contexts:
                stack.enter_context(c)
            t0 = time.perf_counter()
            p.run(steps)
            p.block_until_ready()
            times.append((time.perf_counter() - t0) / steps * 1e3)
    print(f"phase 12: warm rain, {steps} more steps: {times[0]!r} ms/step"
          f" through K2 and K4, {times[1]!r} ms/step with their twins in"
          f" their places [{gpu}]")


# config #2, the de Jong/Mackay 2023 breakup box, at the JAX bench's size
# (``bench.py:183-228``)
BREAKUP_N = 2**17
BREAKUP_STEPS = 100
# float32 operations K5 runs per slot (collision kernel, three pair-keyed
# draws, gamma, the process choice, the Berry efficiency with its four powf)
# and per breaking slot (the fragment mass and the transfer: nine
# exp-and-compare candidates, three logs, the rescale), each transcendental
# call counted as one operation
K5_OPS_PER_SLOT = 60
K5_OPS_PER_BREAKUP = 150
# substeps of config #2 captured for phase 13 (4.2 MB each: 16 exceed the L2)
K5_CAPTURED = 16


def k5_state(n, K, n_ext, ext_dtype, seed):
    """K5's inputs as numpy: multiplicities up to 2^40 with 5% dead slots and
    5% ties with the partner (K - o) mod n; radii log-uniform in 5-500 um;
    extensive rows signed water mass and, past the first, tracers;
    float32 rows of volume, radius and a monotone stand-in fall velocity"""
    import numpy as np

    rng = np.random.default_rng(seed)
    mult = rng.integers(1, 2**40, size=n).astype(np.int64)
    partner = (K - np.arange(n)) % n
    tie = rng.uniform(size=n) < 0.05
    mult[partner[tie]] = mult[tie]
    mult[rng.uniform(size=n) < 0.05] = 0
    radius = np.exp(rng.uniform(np.log(5e-6), np.log(500e-6), n))
    volume = 4 / 3 * np.pi * radius**3
    ext = np.concatenate([
        volume[None, :] * 1e3, rng.uniform(1e-18, 1e-16, (n_ext - 1, n))
    ]).astype(ext_dtype)
    attrs = {
        "volume": volume.astype(np.float32),
        "radius": radius.astype(np.float32),
        "relative fall velocity": (4 * (radius / 50e-6) ** 0.5).astype(
            np.float32
        ),
    }
    return mult, ext, attrs


def k5_function_sets():
    """config #2's functions (Geometric, Berry1967, ConstEb(1), Exponential)
    and a set that bounces and coalesces too (ConstantK, ConstEc(0.5),
    ConstEb(0.5), AlwaysN(4)); (kernel object, PairFunctions) each"""
    from pysdm_tpu_torch.dynamics.collisions import (
        breakup_efficiencies as be,
        breakup_fragmentations as bf,
        coalescence_efficiencies as ce,
        collision_kernels as ck,
    )
    from pysdm_tpu_torch.models.dejong_mackay_et_al_2023 import Settings0D
    from pysdm_tpu_torch.ops.cuda.breakup import PairFunctions

    s = Settings0D()
    constant = ck.ConstantK(a=1e-9)
    return {
        "config2": (s.kernel, PairFunctions.of(
            s.kernel, s.coal_eff, s.break_eff, s.fragmentation
        )),
        "mixed": (constant, PairFunctions.of(
            constant, ce.ConstEc(0.5), be.ConstEb(0.5), bf.AlwaysN(4)
        )),
    }


def k5_args(torch, state, kernel, functions, K, device):
    """the wrapper's arguments on ``device``, with a scale that gives the
    median pair about one expected collision"""
    import numpy as np

    from pysdm_tpu_torch.ops.cuda.breakup import required_rows

    mult, ext, attrs = state
    rows = {
        name: torch.from_numpy(attrs[name]).to(device)
        for name in required_rows(functions)
    }
    partner = torch.remainder(K - torch.arange(mult.shape[0], device=device), mult.shape[0])
    values = kernel.pairwise(None, rows, {k: v[partner] for k, v in rows.items()})
    scale = 1.0 / (
        np.median(mult[mult > 0]) * float(torch.median(values.float()))
    )
    return (
        torch.from_numpy(mult).to(device), torch.from_numpy(ext).to(device),
        0, rows, functions,
        torch.tensor([scale], dtype=torch.float32, device=device), K,
        2718281828, 2**63 // int(2e5),
    )


def compare_k5(got, want, processes, mult0, wm_index=0, require_changes=True):
    """kernel (or twin) ``got`` against ``want``: multiplicities equal at
    coalescing, bouncing and idle slots; at breakup slots, whose float32
    transfer runs through expf/logf/log1pf (a few ulps apart between two
    libms), equal on > 99.9% of all slots and within rel 1e-4 elsewhere
    (the JAX package's own bound, ``tests/unit/test_pallas_breakup.py``);
    extensive rows to rtol 1e-6 where the multiplicities agree; the five
    sums to rtol 1e-5 (another summation order); total water mass (row
    ``wm_index``) to 5e-6. With ``require_changes`` the update must touch
    5-95% of the slots and break some up (random states; a config #2
    substep may touch fewer). Returns (the largest absolute difference of
    the extensive rows, the number of multiplicities that differ)."""
    import numpy as np

    got = [x.cpu().numpy() for x in got]
    want = [x.cpu().numpy() for x in want]
    broke = processes["breakup"].cpu().numpy()
    same = got[0] == want[0]
    if not (same | broke).all():
        raise AssertionError("K5: a coalescing or bouncing slot differs")
    rel = np.abs(got[0] - want[0].astype(float)) / np.maximum(
        np.maximum(got[0], want[0]), 1
    )
    if not (same.mean() > 0.999 and rel.max() < 1e-4):
        raise AssertionError(
            f"K5: {int((~same).sum())} multiplicities differ, rel {rel.max()!r}"
        )
    changed = float((want[0] != mult0).mean())
    if require_changes and not (0.05 < changed < 0.95 and broke.any()):
        raise AssertionError(f"K5 touched {changed} of the slots")
    np.testing.assert_allclose(got[1][:, same], want[1][:, same], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    water = [
        float((m * e[wm_index].astype(float)).sum())
        for m, e in (got[:2], want[:2])
    ]
    np.testing.assert_allclose(water[0], water[1], rtol=5e-6)
    return float(np.abs(got[1].astype(float) - want[1]).max()), int((~same).sum())


def _k5_vs_twin(torch, k5, device, gpu):
    """phase 13: K5 against its twin on the card at 2^17 and 2^20 with both
    function sets; returns (max_abs_err, kernel_ms, twin_ms, bytes, ops) of
    the main path's shape (config #2's functions at 2^17, one float32
    extensive row)"""
    import numpy as np

    sets = k5_function_sets()
    out = None
    for n, name, n_ext, ext_dtype in (
        (BREAKUP_N, "config2", 1, np.float32),
        (BREAKUP_N, "mixed", 2, np.float64),
        (2**20, "config2", 2, np.float32),
        (2**20, "mixed", 1, np.float32),
    ):
        K = n // 3 * 2 + 1
        state = k5_state(n, K, n_ext, ext_dtype, seed=n + n_ext)
        kernel, functions = sets[name]
        args = k5_args(torch, state, kernel, functions, K, device)
        before = k5.coalesce_breakup_mirror.launches
        got = k5.coalesce_breakup_mirror(*args)
        torch.cuda.synchronize()
        if k5.coalesce_breakup_mirror.launches != before + 1:
            raise AssertionError("K5's counter did not count the launch")
        processes = {}
        want = k5.coalesce_breakup_mirror_reference(*args, processes=processes)
        err, n_diff = compare_k5(got, want, processes, state[0])
        n_break = int(processes["breakup"].sum())
        kernel_ms = _time_ms(torch, lambda: k5.coalesce_breakup_mirror(*args), 200)
        twin_ms = _time_ms(
            torch, lambda: k5.coalesce_breakup_mirror_reference(*args), 10
        )
        print(f"phase 13: K5 n={n} {name} n_ext={n_ext}"
              f" {np.dtype(ext_dtype).name}: {n_break} breakup slots,"
              f" {int(processes['coalescence'].sum())} coalescence slots,"
              f" {n_diff} multiplicities differ; ext max abs err {err!r};"
              f" kernel {kernel_ms!r} ms, plain twin {twin_ms!r} ms [{gpu}]")
        if out is None:
            # each input read once (mult 8, rows 4 each, attribute rows 4
            # each), each output written once (mult 8, rows 4 each)
            n_bytes = n * (8 + 4 * n_ext + 4 * len(args[3]) + 8 + 4 * n_ext)
            n_ops = n * K5_OPS_PER_SLOT + n_break * K5_OPS_PER_BREAKUP
            out = (err, kernel_ms, twin_ms, n_bytes, n_ops)
            main_args = args

    # the main shape over 16 random states of 4.2 MB each, together past
    # the 50 MB L2
    kernel, functions = sets["config2"]
    inputs = [main_args] + [
        k5_args(torch, k5_state(BREAKUP_N, K, 1, np.float32, seed), kernel,
                functions, K, device)
        for seed, K in enumerate(range(1001, 1016))
    ]
    check_deterministic(
        torch, k5.coalesce_breakup_mirror, inputs[:2], "phase 13: K5"
    )
    rotated_ms = _time_rotated_ms(
        torch, lambda a: k5.coalesce_breakup_mirror(*a), inputs, 200
    )
    print(f"phase 13: K5 n={BREAKUP_N} config2 over a rotation of"
          f" {len(inputs)} random states (device memory): {rotated_ms!r} ms"
          f" [{gpu}]")

    # the states config #2's main path hands K5
    captured = capture_k5_substeps(k5, K5_CAPTURED)
    err = out[0]
    counts = np.zeros(3, dtype=np.int64)
    for args in captured:
        got = k5.coalesce_breakup_mirror(*args)
        processes = {}
        want = k5.coalesce_breakup_mirror_reference(*args, processes=processes)
        e, _ = compare_k5(
            got, want, processes, args[0].cpu().numpy(), wm_index=args[2],
            require_changes=False,
        )
        err = max(err, e)
        counts += [
            int((want[0] != args[0]).sum()),
            int(processes["coalescence"].sum()),
            int(processes["breakup"].sum()),
        ]
    one_ms = _time_ms(torch, lambda: k5.coalesce_breakup_mirror(*captured[0]), 200)
    captured_ms = _time_rotated_ms(
        torch, lambda a: k5.coalesce_breakup_mirror(*a), captured, 200
    )
    print(f"phase 13: K5 on {len(captured)} substeps captured from config"
          f" #2's main path (2^17 slots each): within compare_k5's bounds of"
          f" the twin; per substep {counts[0] / len(captured)!r} slots"
          f" changed, {counts[1] / len(captured)!r} coalescence and"
          f" {counts[2] / len(captured)!r} breakup slots; kernel"
          f" {one_ms!r} ms on the first (in the L2), {captured_ms!r} ms over"
          f" the rotation [{gpu}]")
    return (err, *out[1:])


def capture_k5_substeps(k5, count):
    """the arguments of ``count`` K5 calls on config #2's main path
    (``build_breakup_box`` on the card, one step of warm-up first), cloned
    before each call"""
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.dynamics.collisions import collision

    p = build_breakup_box(BREAKUP_N, GPU)
    p.run(1)
    captured = []

    def record(mult, ext, wm_index, attrs, functions, scale, *rest):
        captured.append((
            mult.clone(), ext.clone(), wm_index,
            {name: row.clone() for name, row in attrs.items()}, functions,
            scale.clone(), *rest,
        ))
        return k5.coalesce_breakup_mirror(
            mult, ext, wm_index, attrs, functions, scale, *rest
        )

    with _replaced(collision, "coalesce_breakup_mirror", record):
        while len(captured) < count:
            p.run(1)
    p.block_until_ready()
    return captured[:count]


def build_breakup_box(n_sd, backend):
    """``bench.py``'s config #2 (``_bench_breakup``): Settings0D(seed=44),
    Collision(Geometric, Berry1967, ConstEb(1), Exponential, adaptive) on a
    Box of dv = 1 m^3, dt = 1 s"""
    from pysdm_tpu_torch import Builder
    from pysdm_tpu_torch.dynamics import Collision
    from pysdm_tpu_torch.environments import Box
    from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu_torch.models.dejong_mackay_et_al_2023 import Settings0D

    s = Settings0D(seed=44, warn_overflows=False)
    s.n_sd = n_sd
    builder = Builder(
        n_sd=n_sd, backend=backend(s.formulae), environment=Box(dv=s.dv, dt=s.dt)
    )
    builder.add_dynamic(Collision(
        collision_kernel=s.kernel, coalescence_efficiency=s.coal_eff,
        breakup_efficiency=s.break_eff, fragmentation_function=s.fragmentation,
        adaptive=s.adaptive, warn_overflows=False,
    ))
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        s.spectrum
    ).sample(n_sd)
    return builder.build(attributes)


def _breakup_main_path(k5, gpu):
    """phase 14: config #2 through ``bench.py``'s recipe on the card;
    returns K5's launches in the timed steps"""
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.dynamics.collisions import collision

    p = build_breakup_box(BREAKUP_N, GPU)
    mass0, count0 = _totals(p)
    p.run(1)
    p.block_until_ready()
    dyn = p.dynamics["Collision"]
    substeps0, reads0 = dyn.substeps_run, dyn.host_reads
    k5.coalesce_breakup_mirror.launches = 0
    t0 = time.perf_counter()
    p.run(BREAKUP_STEPS)
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = k5.coalesce_breakup_mirror.launches
    substeps = dyn.substeps_run - substeps0
    if launches != substeps or substeps < BREAKUP_STEPS:
        raise AssertionError(f"{launches} K5 launches for {substeps} substeps")
    mass1, count1 = _totals(p)
    if abs(mass1 - mass0) > 1e-5 * mass0:
        raise AssertionError(f"phase 14: water mass {mass0} -> {mass1}")
    rates = {
        name: float(p.get_counter(name).sum())
        for name in ("collision_rate", "coalescence_rate", "breakup_rate",
                     "collision_rate_deficit", "breakup_rate_deficit")
    }
    if not (rates["coalescence_rate"] > 0 and rates["breakup_rate"] > 0):
        raise AssertionError(f"phase 14: rates {rates}")
    print(f"phase 14: breakup box (config #2) n_sd={BREAKUP_N}, adaptive,"
          f" {BREAKUP_STEPS} steps after one:"
          f" {BREAKUP_N / 2 * BREAKUP_STEPS / elapsed!r} pair-updates/s,"
          f" {elapsed / BREAKUP_STEPS * 1e3!r} ms/step, {launches} K5"
          f" launches = {substeps} substeps, host reads"
          f" {(dyn.host_reads - reads0) / BREAKUP_STEPS!r}/step; water mass"
          f" drift {(mass1 - mass0) / mass0!r}, droplets {count0!r} ->"
          f" {count1!r}; rates {rates} [{gpu}]")

    n_plain = 10
    times = []
    twin = _replaced(
        collision, "coalesce_breakup_mirror", k5.coalesce_breakup_mirror_reference
    )
    for context in (contextlib.nullcontext(), twin):
        with context:
            t0 = time.perf_counter()
            p.run(n_plain)
            p.block_until_ready()
            times.append((time.perf_counter() - t0) / n_plain * 1e3)
    print(f"phase 14: {n_plain} more steps: {times[0]!r} ms/step through K5,"
          f" {times[1]!r} ms/step with the plain twin in its place [{gpu}]")
    return launches


def _breakup_model(k5, gpu):
    """phase 15: config #2 through its model entry point,
    ``run_box_breakup(Settings0D(), backend_class=GPU)``, at the bench's
    2^17 super-droplets, spectra read at 0, 25, 50 and 100 s"""
    import numpy as np

    from pysdm_tpu_torch.models import dejong_mackay_et_al_2023 as model

    settings = model.Settings0D()
    settings.n_sd = BREAKUP_N
    settings._steps = [0, 25, 50, 100]
    k5.coalesce_breakup_mirror.launches = 0
    t0 = time.perf_counter()
    out = model.run_box_breakup(settings, return_nv=True)
    elapsed = time.perf_counter() - t0
    launches = k5.coalesce_breakup_mirror.launches
    core = out.core
    if core.device.type != "cuda":
        raise AssertionError(f"run_box_breakup built on {core.device}")
    substeps = core.dynamics["Collision"].substeps_run
    if launches != substeps or substeps < settings._steps[-1]:
        raise AssertionError(f"{launches} K5 launches for {substeps} substeps")
    if not (np.isfinite(out.y).all() and np.isfinite(out.y2).all()):
        raise AssertionError("run_box_breakup: non-finite spectrum")
    for name in ("dv/dlnr", "N(v)"):
        product = core.products[name]
        if not np.array_equal(product.get(), product.get()):
            raise AssertionError(f"run_box_breakup: {name} read twice differs")
    dlnr = np.diff(np.log(settings.radius_bins_edges))
    liquid = (out.y * dlnr).sum(axis=1)  # kg per m^3 of air under dv/dlnr
    drift = np.abs(liquid / liquid[0] - 1).max()
    collision, _, coalescence, breakup = out.rates[-1]
    if not (drift < 1e-4 and coalescence > 0 and breakup > 0):
        raise AssertionError(
            f"run_box_breakup: liquid {liquid}, rates {out.rates[-1]}"
        )
    print(f"phase 15: run_box_breakup(Settings0D(), backend_class=GPU) at"
          f" n_sd={BREAKUP_N}, {settings._steps[-1]} steps in {elapsed!r} s:"
          f" {launches} K5 launches; liquid under dv/dlnr {liquid.tolist()}"
          f" kg/m^3 (max drift {drift!r}); number"
          f" {(out.y2.sum(axis=1)).tolist()} m^-3; rates (collision,"
          f" deficit, coalescence, breakup) {out.rates[-1].tolist()} [{gpu}]")


# config #4, the Shipway and Hill 2012 1D column, at the JAX model's defaults
# (dz = 25 m, dt = 1 s, 3 km and a 625 m particle reservoir: 145 cells) with
# the warm rain's 2^12 super-droplets per cell
COLUMN_SD_PER_CELL = 2**12
COLUMN_BELOW_CLOUD_STEPS = 100
COLUMN_CLOUD_TIME = 400
COLUMN_BUDGET_STEPS = 30
COLUMN_IN_CLOUD_STEPS = 50


def shipway_hill(backend, products=None, **settings):
    """config #4 through the port's entry point; ``backend`` None takes
    ``Simulation``'s default (the card)"""
    from pysdm_tpu_torch.models import shipway_and_hill_2012 as model

    settings = model.Settings(**settings)
    kwargs = {} if backend is None else {"backend_class": backend}
    return settings, model.Simulation(settings, products=products, **kwargs)


def shipway_hill_published_profiles(backend):
    """the scenario of ``tests/smoke/test_kinematic_1d.py``
    ``test_shipway_hill_published_profile_bounds`` (the reference's
    ``test_few_steps.py``: 128 super-droplets per cell, dt = 30 s, dz =
    60 m, a 660 m reservoir, 50 steps, seed 44); returns the settings and
    each product's profile above z = 0, averaged over the last 10 steps
    and, but for the activation rate, smoothed over 5 cells"""
    import numpy as np
    from scipy.ndimage import uniform_filter1d

    from pysdm_tpu_torch import products
    from pysdm_tpu_torch.physics import si

    settings, simulation = shipway_hill(
        backend,
        products=(
            products.SuperDropletCountPerGridbox(name="sd_count"),
            products.PeakSaturation(name="peak saturation"),
            products.WaterMixingRatio(
                name="cloud water mixing ratio",
                radius_range=(1 * si.um, 50 * si.um),
            ),
            products.ActivatingRate(name="activating"),
            products.AmbientRelativeHumidity(name="RH"),
        ),
        n_sd_per_gridbox=128, dt=30 * si.s, dz=60 * si.m, precip=True,
        rho_times_w_1=2 * si.m / si.s, seed=44,
    )
    p = simulation.particulator
    p.run(40)
    # flush the reset-on-read accumulators (peak saturation, rates) so the
    # last-10-step statistics do not carry the spin-up transient
    for product in p.products.values():
        product.get()
    samples = {name: [] for name in p.products}
    for _ in range(10):
        p.run(1)
        for name, product in p.products.items():
            samples[name].append(np.asarray(product.get()).squeeze().copy())
    reservoir_cells = int(settings.particle_reservoir_depth // settings.dz)
    profiles = {}
    for name, values in samples.items():
        mean = np.mean(np.stack(values), axis=0)[reservoir_cells:]
        profiles[name] = (
            mean if name == "activating" else uniform_filter1d(mean, size=5)
        )
    return settings, profiles


def column_launches(p, run):
    """``run()`` with the launch counts of K2, K3 and K4 (and K4's rows)
    set to 0 just before and read just after, beside the collision
    substeps, the condensation solves and the host reads it took, and its
    seconds on the host clock"""
    from pysdm_tpu_torch.ops.cuda import collision, condensation, scan

    collision_dyn = p.dynamics["Collision"]
    solver = p.dynamics["Condensation"].solver
    before = (collision_dyn.substeps_run, solver.substep_solves, _host_reads(p))
    p.block_until_ready()
    collision.coalesce_adjacent.launches = 0
    condensation.masses_new.launches = 0
    scan.cumsum.launches = 0
    scan.cumsum.rows = 0
    t0 = time.perf_counter()
    run()
    p.block_until_ready()
    seconds = time.perf_counter() - t0
    return {
        "coalesce_adjacent": collision.coalesce_adjacent.launches,
        "masses_new": condensation.masses_new.launches,
        "cumsum": scan.cumsum.launches,
        "cumsum rows": scan.cumsum.rows,
        "collision substeps": collision_dyn.substeps_run - before[0],
        "condensation solves": solver.substep_solves - before[1],
        "host reads": _host_reads(p) - before[2],
        "seconds": seconds,
    }


def _column_window(p, steps, label, gpu):
    """a timed window of the column's main path: launches checked against
    the substeps and solves, the end-to-end numbers printed"""
    counts = column_launches(p, lambda: p.run(steps))
    if (counts["coalesce_adjacent"] != counts["collision substeps"]
            or counts["collision substeps"] < steps):
        raise AssertionError(f"phase 16 {label}: {counts}")
    if (counts["masses_new"] != counts["condensation solves"]
            or counts["masses_new"] < steps or counts["cumsum"] == 0):
        raise AssertionError(f"phase 16 {label}: {counts}")
    wall = counts["seconds"]
    per_step = {
        k: v / steps for k, v in counts.items() if k != "seconds"
    }
    print(f"phase 16: column {label}, {steps} steps: {wall / steps * 1e3!r}"
          f" ms/step, {p.mesh.n_cell * steps / wall!r} grid points/s,"
          f" {p.n_sd * steps / wall!r} droplet-steps/s; per step {per_step};"
          f" displacement substeps up to"
          f" {int(p.get_counter('max_n_substeps_displacement')[0])} [{gpu}]")
    return counts


def _column_water(p):
    """vapour and liquid in the column, kg (float64), after checking
    multiplicities and masses"""
    import numpy as np

    return total_water(p) - float(np.sum(p.get_counter("precipitated_mass")))


def _k4_on_scans(real_k4, scans, label):
    """K4 (``real_k4``) on each of ``scans``, tensors captured from a main
    path, against its twin: integers equal to torch.cumsum, floats within
    1e-5 of the float64 prefix of |x| (phase 8's bound). Returns (the
    largest absolute error of a float scan, a line for each scan)"""
    import torch

    from pysdm_tpu_torch.ops.cuda import scan

    k4_err, seen = 0.0, []
    for x in scans:
        got = real_k4(x)
        if not x.is_floating_point():
            if not torch.equal(got, scan.cumsum_reference(x)):
                raise AssertionError(f"{label}: K4 {x.dtype} not exact")
            seen.append(f"{tuple(x.shape)} {x.dtype}: exact")
            continue
        exact = x.double().cumsum(-1)
        scale = x.double().abs().cumsum(-1)
        err = (got.double() - exact).abs()
        if not (err <= 1e-5 * scale).all():
            raise AssertionError(
                f"{label}: K4 {x.dtype} {tuple(x.shape)}: err {float(err.max())!r}"
            )
        twin = (scan.cumsum_reference(x).double() - exact).abs()
        k4_err = max(k4_err, float(err.max()))
        seen.append(
            f"{tuple(x.shape)} {x.dtype}: max abs err {float(err.max())!r}"
            f" (torch.cumsum {float(twin.max())!r}) of a prefix up to"
            f" {float(scale.max())!r}"
        )
    return k4_err, seen


@contextlib.contextmanager
def _capturing_kernels():
    """inside the block, the first K2 substep, the first K3 solve and the
    first K4 scan of each dtype and rank are kept (clones of their inputs);
    yields {"k2": [args], "k3": [args], "k4": {(dtype, rank): x}}. K3's
    wrapper counts its launches on the module's ``masses_new``, here the
    capture: they are added to its count after the block, so that the
    launch counts stay those of the path"""
    import torch

    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.ops import segments
    from pysdm_tpu_torch.ops.cuda import condensation as k3

    captured = {"k2": [], "k3": [], "k4": {}}

    def cloned(args):
        return [a.clone() if torch.is_tensor(a) else a for a in args]

    def capture_k2(*args):
        if not captured["k2"]:
            captured["k2"].append(cloned(args))
        return real_k2(*args)

    def capture_k3(*args):
        if not captured["k3"]:
            captured["k3"].append(cloned(args))
        return real_k3(*args)

    def capture_k4(x):
        captured["k4"].setdefault((x.dtype, x.dim()), x.clone())
        return real_k4(x)

    capture_k3.launches = 0

    real_k2, real_k3, real_k4 = (
        collision.coalesce_adjacent, k3.masses_new, segments.cumsum
    )
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_replaced(collision, "coalesce_adjacent", capture_k2))
            stack.enter_context(_replaced(k3, "masses_new", capture_k3))
            stack.enter_context(_replaced(segments, "cumsum", capture_k4))
            yield captured
    finally:
        k3.masses_new.launches += capture_k3.launches


def _column_kernels_vs_twins(p, gpu, label="phase 16"):
    """phase 16 at t = 400 s (and phase 22): one more step whose first K2
    substep, first K3 solve (where the column condenses) and first K4 scan
    of each dtype and rank are captured (``_capturing_kernels``); on those
    inputs each kernel against its twin (``_captured_kernels_vs_twins``).
    Returns the largest absolute differences to the twins"""
    with _capturing_kernels() as captured:
        p.run(1)
        p.block_until_ready()
    return _captured_kernels_vs_twins(
        captured, "Condensation" in p.dynamics, gpu, label
    )


def _captured_kernels_vs_twins(captured, condenses, gpu, label, what="column"):
    """each kernel of ``_capturing_kernels``'s capture against its twin on
    the card at the bounds of phases 9, 10 and 8 (K2: xi equal, rows and
    rates to rtol 1e-6, also with the gamma draws scaled by 2^-30 so that
    pairs merge; K3: ``compare_k3_near_saturation``; K4: integers equal to
    torch.cumsum, floats within 1e-5 of the float64 prefix of |x|). Returns
    the largest absolute differences to the twins"""
    import numpy as np

    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    if not (captured["k2"] and captured["k4"]
            and bool(captured["k3"]) == condenses):
        raise AssertionError(f"{label}: a kernel was not called: {captured}")
    real_k2, real_k3, real_k4 = kern.coalesce_adjacent, k3.masses_new, scan.cumsum

    # K2 on the first substep of that step
    mult, ext, kernnorm, rand, is_first = captured["k2"][0]
    k2_seen = {}
    for case, draws in (("as drawn", rand), ("draws x 2^-30", rand * 2**-30)):
        args = (mult, ext, kernnorm, draws, is_first)
        got = [x.cpu().numpy() for x in real_k2(*args)[:4]]
        want = [x.cpu().numpy() for x in kern.coalesce_adjacent_reference(*args)[:4]]
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-6)
        k2_seen[case] = (
            int((got[0] != mult.cpu().numpy()).sum()),
            float(np.abs(got[1].astype(np.float64) - want[1]).max()),
        )
    if k2_seen["draws x 2^-30"][0] == 0:
        raise AssertionError(f"{label}: K2 merged no pair: {k2_seen}")
    print(f"{label}: K2 on a {what} substep ({mult.shape[0]} slots,"
          f" {int(is_first.sum())} pairs): xi equal to the twin, rows and"
          f" rates within rtol 1e-6; (slots changed, ext max abs err)"
          f" {k2_seen} [{gpu}]")

    # K3 on the first solve
    k3_seen = {"mass": None}
    if condenses:
        formulae, settings, *rows = captured["k3"][0]

        def twin_of(rows):
            return k3.masses_new_reference(formulae, settings, *rows)

        k3_seen = compare_k3_near_saturation(
            formulae, settings, rows, real_k3(formulae, settings, *rows),
            twin_of,
        )
        active = int(
            (rows[9][rows[4].long()] & (rows[3] > 0) & (rows[0] > 0)).sum()
        )
        print(f"{label}: K3 on a {what} solve ({rows[0].shape[0]} drops in"
              f" {rows[5].shape[0]} cells, {active} of them active): success"
              f" equal to the twin's and every log-mass inside the twin's"
              f" interval for +-32 ulps of qv; largest differences"
              f" {k3_seen} [{gpu}]")

    # K4 on the scans, one of each dtype and rank
    k4_err, seen = _k4_on_scans(real_k4, captured["k4"].values(), label)
    for line in seen:
        print(f"{label}: K4 on a {what} scan {line}")
    return {"coalesce_adjacent": k2_seen["as drawn"][1],
            "masses_new": k3_seen["mass"], "cumsum": k4_err}


def _column_main_path(gpu):
    """phase 16: config #4 at full width through ``Simulation`` on the card;
    returns the launches of K2, K3 and K4 in the two timed windows and
    their largest differences to their twins on the column's inputs"""
    import numpy as np

    settings, simulation = shipway_hill(None, n_sd_per_gridbox=COLUMN_SD_PER_CELL)
    p = simulation.particulator
    if p.device.type != "cuda":
        raise AssertionError(f"Simulation built on {p.device}")
    if (p.mesh.n_cell, p.n_sd) != (145, 145 * COLUMN_SD_PER_CELL):
        raise AssertionError(f"{p.mesh.n_cell} cells, {p.n_sd} super-droplets")
    t0 = time.perf_counter()
    p.run(1)
    p.block_until_ready()
    print(f"phase 16: column (config #4) {p.mesh.n_cell} cells x"
          f" {COLUMN_SD_PER_CELL} ({p.n_sd} super-droplets), dt ="
          f" {settings.dt} s: first step {time.perf_counter() - t0!r} s")
    below = _column_window(p, COLUMN_BELOW_CLOUD_STEPS, "below cloud", gpu)
    p.run(int(COLUMN_CLOUD_TIME / settings.dt) - p.n_steps)

    first = {name: product.get() for name, product in p.products.items()}
    second = {name: product.get() for name, product in p.products.items()}
    qc = first["qc"]
    mult = p.attributes["multiplicity"]
    if not (qc.max() > 0.05e-3 and (qc > 1e-5).sum() >= 10
            and first["S_max"].max() > 0
            and p.get_counter("condensation_success").all()
            and (mult >= 0).all()):
        raise AssertionError(
            f"no cloud at t = {COLUMN_CLOUD_TIME} s: qc max {qc.max()}, cells"
            f" above 1e-5 {(qc > 1e-5).sum()}, S_max {first['S_max'].max()}"
        )
    # the reads reduce in a fixed order: a second read of the same state is
    # bit-equal, but for the two products that reset their counter on read
    for name, value in first.items():
        expected = {"S_max": np.full_like(value, -1.0),
                    "surf_precip": np.zeros_like(value)}.get(name, value)
        if not (np.isfinite(value).all()
                and np.array_equal(second[name], expected)):
            raise AssertionError(f"phase 16: {name} read twice: {value}, {second[name]}")
        print(f"phase 16: t = {COLUMN_CLOUD_TIME} s, {name}: shape"
              f" {value.shape}, min {float(value.min())!r}, max"
              f" {float(value.max())!r}")
    print(f"phase 16: cloud at t = {COLUMN_CLOUD_TIME} s: qc max"
          f" {float(qc.max()) * 1e3!r} g/kg, {int((qc > 1e-5).sum())} cells"
          f" above 1e-5 kg/kg, S_max {float(first['S_max'].max())!r}; every"
          f" product read twice bit-equal")
    errors = _column_kernels_vs_twins(p, gpu)

    # the water budget over the first steps of the cloud: the column is
    # open, MPDATA's extrapolated bounds let vapour in at the bottom and
    # out at the top (about 2% of the column's water over 30 steps at the
    # updraft's peak), hence 5% as in tests/smoke/test_kinematic_1d.py
    water0, precipitated = _column_water(p), 0.0
    for _ in range(COLUMN_BUDGET_STEPS):
        p.run(1)
        precipitated += float(np.sum(p.get_counter("precipitated_mass")))
    drift = (_column_water(p) + precipitated - water0) / water0
    if not abs(drift) < 0.05:
        raise AssertionError(f"column water drifted by {drift}")
    print(f"phase 16: water budget over {COLUMN_BUDGET_STEPS} steps in cloud:"
          f" drift {drift!r}, precipitated {precipitated!r} kg")

    cloud = _column_window(p, COLUMN_IN_CLOUD_STEPS, "in cloud", gpu)
    if not (p.get_counter("condensation_success").all()
            and (p.attributes["multiplicity"] >= 0).all()):
        raise AssertionError("phase 16: condensation failed in cloud")
    launches = {k: below[k] + cloud[k]
                for k in ("coalesce_adjacent", "masses_new", "cumsum")}
    return launches, errors


def _column_published_on_card(gpu):
    """phase 17: the published-profile scenario on the card, float32, with
    the bounds of ``tests/smoke/test_torch_shipway_hill.py``"""
    settings, profiles = shipway_hill_published_profiles(None)
    n = settings.n_sd_per_gridbox
    sd, peak = profiles["sd_count"], profiles["peak saturation"]
    qc = profiles["cloud water mixing ratio"] * 1e3  # g/kg
    activating = profiles["activating"]
    print(f"phase 17: published-profile scenario on the card: super-droplets"
          f" per cell {float(sd.min())!r}-{float(sd.max())!r}, peak"
          f" saturation max {float(peak.max())!r}, qc"
          f" {float(qc.min())!r}-{float(qc.max())!r} g/kg, activating max"
          f" {float(activating.max())!r} [{gpu}]")
    if not (0.5 * n < sd.min() < 1.5 * n and 0.5 * n < sd.max() < 1.5 * n
            and 1.0001 < peak.max() < 1.001
            and qc.min() < 1e-10 and 0.1 < qc.max() < 0.4
            and activating.max() == 0):
        raise AssertionError("phase 17: a published-profile bound failed")


# -- slice 8: the coalescence-only box models -------------------------------
# Bulenok 2023's mean mass after 64 steps against eq. 13, as a factor either
# way: on the CPU at 2^10 super-droplets the port ends 3.49x and the JAX
# package 4.75x above it (the Monte-Carlo spread at large multiplicities;
# tests/smoke/test_srivastava_1982.py's own run, total number 1e6, ends 10%
# below), hence 5
BULENOK_FACTOR = 5.0
BULENOK_STEPS = 64
BULENOK_N_SDS = (2**17, 2**20)
# de Jong and Azimi's column at full width (Settings1D's defaults: dz =
# 25 m, z_max 3 km and the 625 m reservoir, 145 cells) with the column's
# 2^12 super-droplets per cell
DEJONG_COLUMN_STEPS = 300


def k1_geometric_args(torch, n, kernel_id, ext_dtype, seed, device):
    """K1's arguments on ``_random_state``'s state with the attribute rows
    of a geometric kernel (radii of the volumes, fall velocities of 0-8
    m/s, areas of the radii) and a scale that gives the median pair about
    one expected collision"""
    import numpy as np

    from pysdm_tpu_torch.ops.cuda.collision import (
        GEOMETRIC,
        KERNEL_ROWS,
        kernel_value,
    )

    K = (n // 3) * 2
    mult, ext, volume = _random_state(torch, n, K, ext_dtype, seed, device)
    rng = np.random.default_rng(seed + 1)
    radius = (volume.double() * 3 / 4 / np.pi) ** (1 / 3)
    rows = {
        "radius": radius,
        "relative fall velocity": torch.from_numpy(
            rng.uniform(0.0, 8.0, n)
        ).to(device),
        "area": 4 * np.pi * radius**2,
    }
    attr = torch.stack(
        [rows[name].float() for name in KERNEL_ROWS[kernel_id]]
    ).contiguous()
    params = (np.pi * 0.8, 0.0) if kernel_id == GEOMETRIC else (2e3, 0.0)
    named = dict(zip(KERNEL_ROWS[kernel_id], attr))
    partner = torch.remainder(K - torch.arange(n, device=device), n)
    values = kernel_value(
        kernel_id, *params, named, {k: v[partner] for k, v in named.items()}
    )
    alive = mult[mult > 0].double()
    scale = 1.0 / float(alive.median() * values.double().median())
    return (mult, ext, attr, kernel_id, params,
            torch.tensor([scale], dtype=torch.float32, device=device), K,
            2718281828)


def _k1_geometric_vs_twin(torch, kern, device, gpu):
    """phase 18: K1 with Geometric and SimpleGeometric against its twin on
    the card at 2^16 and 2^20 (multiplicities exactly, rows to rtol 1e-6,
    rate sums to 1e-5), three launches and two streams bit-equal, then
    Geometric's device time at 2^20 on one input and over a rotation of
    four; returns (max_abs_err, ms, rotated ms, bytes)"""
    import numpy as np

    max_abs_err = 0.0
    for kernel_id, name in ((kern.GEOMETRIC, "Geometric"),
                            (kern.SIMPLE_GEOMETRIC, "SimpleGeometric")):
        for n, ext_dtype in ((2**16, np.float64), (N_MAIN, np.float32)):
            args = k1_geometric_args(torch, n, kernel_id, ext_dtype, n, device)
            mult = args[0]
            before = kern.coalesce_mirror.launches
            got = kern.coalesce_mirror(*args)
            torch.cuda.synchronize()
            if kern.coalesce_mirror.launches != before + 1:
                raise AssertionError("K1's counter did not count the launch")
            want = kern.coalesce_mirror_reference(*args)
            got = [x.cpu().numpy() for x in got]
            want = [x.cpu().numpy() for x in want]
            np.testing.assert_array_equal(got[0], want[0])
            changed = float((got[0] != mult.cpu().numpy()).mean())
            if not 0.05 < changed < 0.95:
                raise AssertionError(f"phase 18: {name} touched {changed}")
            rtol = 1e-6 if ext_dtype == np.float32 else 1e-12
            np.testing.assert_allclose(got[1], want[1], rtol=rtol)
            for g, w in zip(got[2:], want[2:]):
                np.testing.assert_allclose(g, w, rtol=1e-5)
            err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
            max_abs_err = max(max_abs_err, err)
            print(f"phase 18: K1 {name} n={n} ext={np.dtype(ext_dtype).name}:"
                  f" xi equal ({changed!r} of the slots changed), ext max abs"
                  f" err {err!r}, rates {got[2:]} vs {want[2:]}")
    args = k1_geometric_args(torch, N_MAIN, kern.GEOMETRIC, np.float32, 7, device)
    inputs = [args] + [
        k1_geometric_args(torch, N_MAIN, kern.GEOMETRIC, np.float32, s, device)
        for s in (11, 12, 13)
    ]
    check_deterministic(torch, kern.coalesce_mirror, inputs[:2], "phase 18: K1")
    kernel_ms = _time_ms(torch, lambda: kern.coalesce_mirror(*args), 200)
    rotated_ms = _time_rotated_ms(
        torch, lambda a: kern.coalesce_mirror(*a), inputs, 200
    )
    # each input read once, each output written once: mult 8, two float32
    # rows 8, two attribute rows 8 in; mult 8, rows 8 out
    n_bytes = N_MAIN * (8 + 8 + 8 + 8 + 8)
    print(f"phase 18: K1 Geometric n={N_MAIN}: kernel {kernel_ms!r} ms on one"
          f" input (in the L2), {rotated_ms!r} ms over a rotation of"
          f" {len(inputs)} inputs; bound {bound_ms(n_bytes)[0]!r} ms"
          f" ({n_bytes / N_MAIN:.0f} B/slot) [{gpu}]")
    return max_abs_err, kernel_ms, rotated_ms, n_bytes


@contextlib.contextmanager
def _capturing_builder(model):
    """``model.Builder`` replaced by a subclass that keeps every
    particulator it builds and its liquid water at the build (in the
    yielded list, as pairs)"""
    built = []
    base = model.Builder

    class Capturing(base):
        def build(self, *args, **kwargs):
            p = super().build(*args, **kwargs)
            built.append((p, _totals(p)[0]))
            return p

    with _replaced(model, "Builder", Capturing):
        yield built


def _shima_model(kern, gpu):
    """phase 19: ``shima_et_al_2009.run`` at 2^20 on the card: dv/dlnr
    against the Golovin solution at t = 1200 s, mass under the spectrum and
    liquid mass conserved, K1 launches = substeps, ``WallTime`` inside the
    host clock around the call"""
    import numpy as np

    from pysdm_tpu_torch.models import shima_et_al_2009 as model

    settings = model.Settings()
    settings.n_sd = N_MAIN
    with _capturing_builder(model) as built:
        kern.coalesce_mirror.launches = 0
        t0 = time.perf_counter()
        vals, wall_time = model.run(settings)
        host = time.perf_counter() - t0
    p, liquid0 = built[0]
    if p.device.type != "cuda":
        raise AssertionError(f"shima_et_al_2009.run built on {p.device}")
    substeps = p.dynamics["Collision"].substeps_run
    launches = kern.coalesce_mirror.launches
    if launches != substeps or substeps != settings.output_steps[-1]:
        raise AssertionError(f"phase 19: {launches} K1 launches, {substeps} substeps")
    if not 0 < wall_time <= host:
        raise AssertionError(f"phase 19: wall time {wall_time} s, host {host} s")
    r_mid = np.sqrt(settings.radius_bins_edges[:-1] * settings.radius_bins_edges[1:])
    analytic = model.golovin_analytic_dvdlnr(
        r_mid, 1200.0, b=1.5e3, x_0=settings.X0, n_part=settings.n_part,
        rho=settings.rho,
    )
    rmse = float(np.sqrt(np.mean(((vals[1200] - analytic) / analytic.max()) ** 2)))
    dlnr = np.diff(np.log(settings.radius_bins_edges))
    spectrum_mass = [float((vals[s] * dlnr).sum()) for s in settings.output_steps]
    liquid1 = _totals(p)[0]
    drift = abs(liquid1 - liquid0) / liquid0
    if not (rmse < 0.15 and np.isfinite(vals[3600]).all()
            and abs(spectrum_mass[1] / spectrum_mass[0] - 1) < 5e-2
            and drift < 1e-6):
        raise AssertionError(
            f"phase 19: rmse {rmse}, spectrum mass {spectrum_mass}, liquid"
            f" {liquid0} -> {liquid1}"
        )
    print(f"phase 19: shima_et_al_2009.run at n_sd={N_MAIN} on the card:"
          f" {substeps} steps, {launches} K1 launches, wall time"
          f" {wall_time!r} s (host clock around the call {host!r} s,"
          f" {N_MAIN / 2 * substeps / wall_time!r} pair-updates/s); dv/dlnr"
          f" rmse against Golovin at t = 1200 s {rmse!r} (bound 0.15); mass"
          f" under the spectrum {spectrum_mass} kg/m^3; liquid drift"
          f" {drift!r} [{gpu}]")


def _box_model_entry_points(kern, gpu):
    """phase 19, after the 2^20 run: the two other entry points over K1 at
    their own defaults on the card, with the JAX package's test bounds:
    ``dejong_azimi.run_box(Settings0D())`` (2^12, adaptive; the number
    falls, the Cloudy.jl comparison's M0 at t = 0 within 2% and at 60 and
    120 s within 50%, the volume conserved to 1e-5, float32 masses) and
    ``bartman_2020_fig_4`` (2^13, dt = 1 s, 10 s and adaptive at 10 s; the
    adaptive run's spectrum at 3600 s no further from dt = 1 s's than 1.25
    times the fixed 10 s run's)"""
    import numpy as np

    from pysdm_tpu_torch.models import dejong_azimi, thesis_benchmarks

    kern.coalesce_mirror.launches = 0
    out = dejong_azimi.run_box(dejong_azimi.Settings0D())
    m0, m1 = out.moments[:, 0], out.moments[:, 1]
    analytic_m0 = np.array([100.0, 4.863406413211965, 0.23652721940076313]) * 1e6
    if not (kern.coalesce_mirror.launches >= 120 and m0[0] > m0[-1]
            and abs(m0[0] / analytic_m0[0] - 1) < 0.02
            and (np.abs(m0[1:] / analytic_m0[1:] - 1) < 0.5).all()
            and np.abs(m1 / m1[0] - 1).max() < 1e-5):
        raise AssertionError(f"phase 19: run_box moments {out.moments}")
    print(f"phase 19: dejong_azimi.run_box(Settings0D()) on the card:"
          f" {kern.coalesce_mirror.launches} K1 launches; M0"
          f" {m0.tolist()} m^-3 (Cloudy.jl's Golovin {analytic_m0.tolist()}),"
          f" M1 drift {float(np.abs(m1 / m1[0] - 1).max())!r} [{gpu}]")
    kern.coalesce_mirror.launches = 0
    runs = thesis_benchmarks.bartman_2020_fig_4(dts=(1.0, 10.0, "adaptive"))
    n_sd = 2**13
    dt1, dt10, adaptive = (runs[(n_sd, dt)][0] for dt in (1.0, 10.0, "adaptive"))
    last10 = max(dt10)
    reference = dt1[max(dt1)]
    err_adaptive = float(np.abs(adaptive[last10] - reference).sum())
    err_fixed = float(np.abs(dt10[last10] - reference).sum())
    if not err_adaptive <= 1.25 * err_fixed:
        raise AssertionError(f"phase 19: bartman {err_adaptive} {err_fixed}")
    print(f"phase 19: bartman_2020_fig_4 on the card at {n_sd}:"
          f" {kern.coalesce_mirror.launches} K1 launches; distance to dt ="
          f" 1 s at 3600 s: adaptive {err_adaptive!r}, fixed 10 s"
          f" {err_fixed!r}; wall times"
          f" {[runs[(n_sd, dt)][1] for dt in (1.0, 10.0, 'adaptive')]} s"
          f" [{gpu}]")


def _berry_model(kern, gpu):
    """phase 20: ``berry_1967.run`` at 2^20 on the card (Geometric on K1,
    Gunn-Kinzer fall velocities): the mean radius grows, liquid conserved,
    K1 launches = substeps; then one substep captured and K1 held against
    its twin on it. Returns the launches"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.models import berry_1967 as model

    settings = model.Settings(steps=[0, 200, 400, 600])
    settings.n_sd = N_MAIN
    with _capturing_builder(model) as built:
        kern.coalesce_mirror.launches = 0
        t0 = time.perf_counter()
        vals, p = model.run(settings)
        p.block_until_ready()
        host = time.perf_counter() - t0
    launches = kern.coalesce_mirror.launches
    substeps = p.dynamics["Collision"].substeps_run
    liquid0 = built[0][1]
    if p.device.type != "cuda" or built[0][0] is not p:
        raise AssertionError(f"berry_1967.run built on {p.device}")
    if launches != substeps or substeps != settings.output_steps[-1]:
        raise AssertionError(f"phase 20: {launches} K1 launches, {substeps} substeps")
    r_mid = np.sqrt(settings.radius_bins_edges[:-1] * settings.radius_bins_edges[1:])
    mean_r = [float((vals[s] * r_mid).sum() / vals[s].sum())
              for s in settings.output_steps]
    liquid1 = _totals(p)[0]
    if abs(liquid1 - liquid0) > 1e-6 * liquid0:
        raise AssertionError(f"phase 20: liquid {liquid0} -> {liquid1}")

    captured = []

    def record(*args):
        captured.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return kern.coalesce_mirror(*args)

    with _replaced(collision, "coalesce_mirror", record):
        p.run(1)
    liquid2 = _totals(p)[0]
    args = captured[0]
    got = [x.cpu().numpy() for x in kern.coalesce_mirror(*args)]
    want = [x.cpu().numpy() for x in kern.coalesce_mirror_reference(*args)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    changed = int((got[0] != args[0].cpu().numpy()).sum())
    drift = abs(liquid2 - liquid1) / liquid1
    if not (mean_r[-1] > mean_r[0] and changed > 0 and drift < 1e-6
            and args[3] == kern.GEOMETRIC):
        raise AssertionError(
            f"phase 20: mean radius {mean_r}, {changed} slots changed, liquid"
            f" {liquid1} -> {liquid2}"
        )
    err = float(np.abs(got[1].astype(np.float64) - want[1]).max())
    print(f"phase 20: berry_1967.run at n_sd={N_MAIN} on the card:"
          f" {substeps} steps in {host!r} s, {launches} K1 launches"
          f" (Geometric); number-weighted mean radius of dv/dlnr {mean_r} m;"
          f" on a captured substep K1 xi equal to the twin ({changed} slots"
          f" changed), ext max abs err {err!r}; liquid drift over it"
          f" {drift!r} [{gpu}]")
    return launches


def _bulenok_model(k5, gpu):
    """phase 21: ``bulenok_2023_benchmark`` at 2^17 and 2^20, 64 steps, on
    the card (K5): pair-updates/s, the final mean mass within
    BULENOK_FACTOR of eq. 13, multiplicities >= 0, K5 launches = substeps;
    K5 against its twin on the 2^20 run's 32nd substep. Returns K5's
    launches"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.models import srivastava_1982, thesis_benchmarks

    captured = []

    def record(*args):
        if len(captured) < 32:
            captured.append(
                [a.clone() if torch.is_tensor(a) else
                 {k: v.clone() for k, v in a.items()} if isinstance(a, dict)
                 else a for a in args]
            )
        return k5.coalesce_breakup_mirror(*args)

    launches = 0
    for n_sd in BULENOK_N_SDS:
        with _capturing_builder(srivastava_1982) as built, contextlib.ExitStack() as stack:
            if n_sd == BULENOK_N_SDS[-1]:
                stack.enter_context(
                    _replaced(collision, "coalesce_breakup_mirror", record)
                )
            k5.coalesce_breakup_mirror.launches = 0
            result = thesis_benchmarks.bulenok_2023_benchmark(
                n_sds=(n_sd,), n_steps=BULENOK_STEPS
            )[n_sd]
        p = built[0][0]
        substeps = p.dynamics["Collision"].substeps_run
        count = k5.coalesce_breakup_mirror.launches
        ratio = result["mean_mass_final"] / result["analytic_final"]
        mult = p.attributes["multiplicity"]
        if (p.device.type != "cuda" or count != substeps
                or substeps != BULENOK_STEPS or (mult < 0).any()
                or not 1 / BULENOK_FACTOR < ratio < BULENOK_FACTOR):
            raise AssertionError(
                f"phase 21: n_sd={n_sd} on {p.device}: {count} K5 launches,"
                f" {substeps} substeps, mean mass {result}"
            )
        launches += count
        rates = {name: float(p.get_counter(name).sum())
                 for name in ("coalescence_rate", "breakup_rate",
                              "breakup_rate_deficit", "collision_rate_deficit")}
        print(f"phase 21: bulenok_2023_benchmark n_sd={n_sd}, {BULENOK_STEPS}"
              f" steps: {result['pair_updates_per_s']!r} pair-updates/s,"
              f" {result['wall_time']!r} s; mean mass / fragment mass"
              f" {result['mean_mass_final']!r} against eq. 13's"
              f" {result['analytic_final']!r} (ratio {ratio!r}, bound"
              f" {BULENOK_FACTOR}); {count} K5 launches; multiplicity max"
              f" {int(mult.max())}; rates {rates} [{gpu}]")
    args = captured[-1]
    got = k5.coalesce_breakup_mirror(*args)
    processes = {}
    want = k5.coalesce_breakup_mirror_reference(*args, processes=processes)
    err, n_diff = compare_k5(
        got, want, processes, args[0].cpu().numpy(), wm_index=args[2],
        require_changes=False,
    )
    print(f"phase 21: K5 on the 2^20 run's substep {len(captured)}: within"
          f" compare_k5's bounds of the twin; {int(processes['coalescence'].sum())}"
          f" coalescence and {int(processes['breakup'].sum())} breakup slots,"
          f" {n_diff} multiplicities differ, ext max abs err {err!r} [{gpu}]")
    return launches


def _column_products(products):
    """every liquid-phase product that applies to a column whose particles
    carry no aerosol (no activation filter, no condensation)"""
    import numpy as np

    from pysdm_tpu_torch.physics import si

    bins = np.logspace(np.log10(1 * si.um), np.log10(5e3 * si.um), num=65)
    cloud = (1 * si.um, np.inf)
    return (
        products.ParticleVolumeVersusRadiusLogarithmSpectrum(bins, name="dv/dlnr"),
        products.NumberSizeSpectrum(bins, name="N(r)"),
        products.ParticleSizeSpectrumPerVolume(bins, name="dN/dr"),
        products.ParticleSizeSpectrumPerMassOfDryAir(bins, name="dN/dr/rhod"),
        products.RadiusBinnedNumberAveragedTerminalVelocity(bins, name="vt(r)"),
        products.TotalParticleConcentration(name="N"),
        products.TotalParticleSpecificConcentration(name="n"),
        products.ParticleConcentration(radius_range=(50 * si.um, np.inf), name="N rain"),
        products.ParticleSpecificConcentration(radius_range=cloud, name="n cloud"),
        products.MeanRadius(name="mean r"),
        products.MeanVolumeRadius(name="mean volume r"),
        products.EffectiveRadius(name="reff"),
        products.RadiusStandardDeviation(name="sd r"),
        products.AreaStandardDeviation(name="sd area"),
        products.VolumeStandardDeviation(name="sd v"),
        products.WaterMixingRatio(name="qc", radius_range=cloud),
        products.CloudWaterContent(name="cwc"),
        products.SpecificCloudWaterContent(name="scwc"),
        products.LiquidWaterContent(name="lwc"),
        products.SpecificLiquidWaterContent(name="slwc"),
        products.ZerothMoment(name="M0"),
        products.VolumeFirstMoment(name="M1"),
        products.VolumeSecondMoment(name="M2"),
        products.RadiusFirstMoment(name="R1"),
        products.RadiusSixthMoment(name="R6"),
        products.SuperDropletCountPerGridbox(name="sd count"),
        products.Time(name="time"),
        products.CollisionTimestepMin(name="dt coll min"),
        products.CollisionTimestepMean(name="dt coll mean"),
        products.CoalescenceRatePerGridbox(name="coalescence rate"),
        products.AmbientTemperature(name="T"),
        products.AmbientPressure(name="p"),
        products.AmbientRelativeHumidity(name="RH"),
        products.AmbientRelativeHumidityWrtIce(name="RH ice"),
        products.AmbientDryAirDensity(name="rhod"),
        products.AmbientDryAirPotentialTemperature(name="thd"),
        products.AmbientWaterVapourMixingRatio(name="qv"),
        products.MaxCourantNumber(name="max courant"),
        products.FlowVelocityComponent(0, name="w"),
        products.AveragedTerminalVelocity(name="vt", radius_range=cloud),
        products.SurfacePrecipitation(name="surf_precip"),
    )


# products that read and reset a counter: a second read right after the
# first sees what accumulated in between, nothing
_RESET_ON_READ = ("dt coll mean", "coalescence rate", "surf_precip")


def _dejong_column(gpu):
    """phase 22: de Jong and Azimi's ``Settings1D`` through the port's
    column ``Simulation`` at full width on the card (K2, K4): 300 steps,
    pairs merging, liquid conserved with the precipitation counted; K2 and
    K4 held against their twins on one captured substep and scan; every
    applicable product read twice. Returns the launches of K2 and K4"""
    import numpy as np

    from pysdm_tpu_torch import products
    from pysdm_tpu_torch.models import dejong_azimi
    from pysdm_tpu_torch.models.shipway_and_hill_2012 import Simulation
    from pysdm_tpu_torch.ops.cuda import collision, scan

    settings = dejong_azimi.Settings1D(n_sd_per_gridbox=COLUMN_SD_PER_CELL)
    p = Simulation(settings, products=_column_products(products)).particulator
    if p.device.type != "cuda" or "Condensation" in p.dynamics:
        raise AssertionError(f"phase 22: on {p.device}, {list(p.dynamics)}")
    if (p.mesh.n_cell, p.n_sd) != (145, 145 * COLUMN_SD_PER_CELL):
        raise AssertionError(f"{p.mesh.n_cell} cells, {p.n_sd} super-droplets")
    liquid0, count0 = _totals(p)
    dyn = p.dynamics["Collision"]
    substeps0 = dyn.substeps_run
    collision.coalesce_adjacent.launches = 0
    scan.cumsum.launches = 0
    scan.cumsum.rows = 0
    precipitated = 0.0
    t0 = time.perf_counter()
    for _ in range(DEJONG_COLUMN_STEPS):
        p.run(1)
        precipitated += float(np.sum(p.get_counter("precipitated_mass")))
    p.block_until_ready()
    wall = time.perf_counter() - t0
    substeps = dyn.substeps_run - substeps0
    k2 = collision.coalesce_adjacent.launches
    k4, k4_rows = scan.cumsum.launches, scan.cumsum.rows
    liquid1, count1 = _totals(p)
    first = {name: product.get() for name, product in p.products.items()}
    second = {name: product.get() for name, product in p.products.items()}
    coalescence = float(first["coalescence rate"].sum())
    drift = (liquid1 + precipitated - liquid0) / liquid0
    # float32 masses on the card: each merge rounds e_k + gamma e_j once
    if not (k2 == substeps >= DEJONG_COLUMN_STEPS and k4 > 0
            and coalescence > 0 and count1 < count0 and abs(drift) < 1e-5):
        raise AssertionError(
            f"phase 22: K2 {k2}, substeps {substeps}, K4 {k4}, coalescence"
            f" {coalescence}, droplets {count0} -> {count1}, liquid drift {drift}"
        )
    for name, value in first.items():
        expected = np.zeros_like(value) if name in _RESET_ON_READ else value
        if name == "dt coll mean":
            expected = np.full_like(value, np.nan)
        if name == "dt coll min":
            # its counter was reset by the first read of "dt coll mean"
            expected = np.full_like(value, settings.dt)
        if not np.array_equal(second[name], expected, equal_nan=True):
            raise AssertionError(f"phase 22: {name} read twice: {value}, {second[name]}")
        if not np.isfinite(value).any():
            raise AssertionError(f"phase 22: {name} not finite: {value}")
    print(f"phase 22: de Jong-Azimi column {p.mesh.n_cell} cells x"
          f" {COLUMN_SD_PER_CELL}, {DEJONG_COLUMN_STEPS} steps in {wall!r} s"
          f" ({wall / DEJONG_COLUMN_STEPS * 1e3!r} ms/step,"
          f" {p.n_sd * DEJONG_COLUMN_STEPS / wall!r} droplet-steps/s):"
          f" {substeps} collision substeps = {k2} K2 launches, {k4} K4"
          f" launches of {k4_rows} rows; coalescence rate"
          f" {coalescence!r} since t = 0; droplets {count0!r} -> {count1!r};"
          f" liquid drift {drift!r} with {precipitated!r} kg precipitated;"
          f" {len(first)} products read twice, bit-equal but for the"
          f" {len(_RESET_ON_READ)} that reset on read [{gpu}]")
    for name in ("N", "mean r", "reff", "slwc", "max courant", "w"):
        value = first[name]
        print(f"phase 22: {name}: shape {value.shape}, min"
              f" {float(np.nanmin(value))!r}, max {float(np.nanmax(value))!r}")
    _column_kernels_vs_twins(p, gpu, label="phase 22")
    return {"coalesce_adjacent": k2, "cumsum": k4}


ICE_N = 2**17
SPICHTINGER_STEPS = 400
ABADE_STEPS = 700
# the admitted ranges of the homogeneous rates: Delta a_w in Koop et al.
# 2000 (0.26-0.34), T in Koop & Murray 2016 (a homogeneous freezing window
# of pure water drops, 224-240 K)
KOOP_DA_W_ICE = (0.26, 0.34)
KOOP_MURRAY_T = (224.0, 240.0)


def _mixed_formulae():
    from pysdm_tpu_torch import Formulae

    return Formulae(seed=44, particle_shape_and_density="MixedPhaseSpheres")


def _k3_mixed_phase(torch, k3, device, gpu):
    """phase 23: K3 on a mixed-phase state, ``ICE_N`` drops of which every
    fourth is ice (``k3_rows_with_ice``), against its twin on the card by
    ``compare_k3``, the ice bit-equal to its input and solved in both; then
    the kernel's time on these rows beside the same rows all liquid, in
    turns. Returns (max_abs_err, mixed ms, liquid ms, bound (ms, by), the
    minfun evaluations the rows need)"""
    import numpy as np

    from pysdm_tpu_torch.ops.condensation import DropSolveSettings

    formulae = _mixed_formulae()
    settings = DropSolveSettings(*K3_SETTINGS)
    liquid = settle_haze(formulae, k3_rows(ICE_N, seed=ICE_N), device)
    rows = k3_rows_with_ice(liquid)
    ice = rows["water_mass"] < 0
    before = k3.masses_new.launches
    kernel = k3_call(k3.masses_new, formulae, settings, rows, device)
    if k3.masses_new.launches != before + 1:
        raise AssertionError("phase 23: K3's counter did not count the launch")
    twin = k3_call(k3.masses_new_reference, formulae, settings, rows, device)
    for mass, success in (kernel, twin):
        check_k3_ice(rows, mass, success)
        if not np.isfinite(mass).all():
            raise AssertionError("phase 23: a non-finite mass")
    check_k3_regimes(rows, *kernel)
    abs_err, rel_err = compare_k3(rows, kernel, twin, settings.rtol_x)
    # the liquid drops of the mixed rows: what the same drops give alone
    alone = k3_call(k3.masses_new, formulae, settings, liquid, device)
    for got, want in zip(kernel, alone):
        if (got[~ice] != want[~ice]).any():
            raise AssertionError("phase 23: the ice changed a liquid drop")
    args = {
        name: [torch.from_numpy(r[k]).to(device) for k in K3_ARGS]
        for name, r in (("mixed", rows), ("liquid", liquid))
    }
    ms = {"mixed": [], "liquid": []}
    for name in ("liquid", "mixed", "mixed", "liquid"):
        ms[name].append(_time_ms(
            torch, lambda: k3.masses_new(formulae, settings, *args[name]), 50
        ))
    evaluations = k3_evaluations(k3, formulae, settings, args["mixed"])
    bound = bound_ms(ICE_N * 29, evaluations * K3_OPS_PER_MINFUN)
    print(f"phase 23: K3 on {ICE_N} drops, {int(ice.sum())} of them ice:"
          f" the ice bit-equal and solved in kernel and twin, success equal,"
          f" mass max abs diff {abs_err!r} kg, max rel diff {rel_err!r}, the"
          f" liquid drops bit-equal to the same rows without ice; kernel"
          f" {ms['mixed']} ms, the rows all liquid {ms['liquid']} ms (in"
          f" turns); {evaluations} minfun evaluations, bound {bound[0]!r} ms"
          f" ({bound[1]}) [{gpu}]")
    return (abs_err, min(ms["mixed"]), min(ms["liquid"]), bound, evaluations)


def _alpert_knopf(backend, gpu, n_sd_list=(1000, ICE_N)):
    """phase 24: ``alpert_and_knopf_2016.simulation`` with the settings of
    ``TestAlpertKnopf2016`` (J_het = 1e7 /m^2/s on 1e-9 m^2, dt = 10 s, 20
    steps), at 1000 drops and at ``ICE_N``: the unfrozen fraction within 4
    binomial sigma of exp(-J A t) at every output, and monotone"""
    import numpy as np

    from pysdm_tpu_torch.initialisation import spectra
    from pysdm_tpu_torch.models import alpert_and_knopf_2016

    J_het, A, dt, nt = 1e7, 1e-9, 10.0, 20
    for n_sd in n_sd_list:
        volume = n_sd * 1e-9  # 1e9 droplets per m^3, as the test's 1000 in 1e-6
        t0 = time.perf_counter()
        f_ufz, a_tot = alpert_and_knopf_2016.simulation(
            constants={"J_HET": J_het}, seed=1, n_sd=n_sd, time_step=dt,
            volume=volume,
            spectrum=spectra.Lognormal(norm_factor=n_sd / volume, m_mode=A,
                                       s_geom=1.0),
            droplet_volume=1e-18, multiplicity=1, total_time=dt * nt,
            number_of_real_droplets=n_sd, cooling_rate=0,
            heterogeneous_ice_nucleation_rate="Constant",
            initial_temperature=240.0, backend_class=backend,
        )
        wall = time.perf_counter() - t0
        f = np.asarray(f_ufz)
        expected = np.exp(-J_het * A * dt * np.arange(len(f)))
        sigma = np.sqrt(expected * (1 - expected) / n_sd)
        worst = float(np.max(np.abs(f - expected)[1:] / sigma[1:]))
        if not (worst < 4 and (np.diff(f) <= 0).all() and a_tot[-1] < a_tot[0]):
            raise AssertionError(
                f"phase 24: n_sd={n_sd}: unfrozen {f}, expected {expected},"
                f" {worst} sigma; A_tot {a_tot[0]} -> {a_tot[-1]}"
            )
        print(f"phase 24: Alpert & Knopf 2016 box, {n_sd} drops, {nt} steps"
              f" in {wall!r} s: unfrozen fraction {float(f[-1])!r} against"
              f" exp(-J A t) {float(expected[-1])!r}, at most {worst!r} binomial"
              f" sigma off, monotone [{gpu}]")


def _total_water(p, m_d):
    """vapour plus liquid plus ice per dry-air mass, in float64"""
    import numpy as np

    water = p.attributes["multiplicity"].astype(float) * np.abs(
        p.attributes["signed water mass"].astype(float)
    )
    return float(p.get_env("qv")[0]) + float(water.sum()) / m_d


def _device_busy_us(prof, path):
    """the union of the kernel intervals in ``prof``'s trace (written to
    ``path``), in microseconds"""
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"
    )
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total, len(spans)


def _profile_steps(p, steps, name):
    """``2 steps`` more steps of ``p``: ``steps`` timed on the host clock
    (ending in a synchronise), then ``steps`` under ``torch.profiler``, the
    trace in ``build/profiles/trace_<name>.json``: {ms/step unprofiled,
    device kernels a step, the device's busy time a step (us), that busy
    time over the unprofiled and over the profiled wall time}"""
    import os

    from torch.profiler import ProfilerActivity, profile

    p.block_until_ready()
    t0 = time.perf_counter()
    p.run(steps)
    p.block_until_ready()
    ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.run(steps)
        p.block_until_ready()
        wall_prof = time.perf_counter() - t0
    os.makedirs(os.path.join("build", "profiles"), exist_ok=True)
    busy, kernels = _device_busy_us(
        prof, os.path.join("build", "profiles", f"trace_{name}.json")
    )
    return {
        "ms_per_step": ms,
        "kernels_per_step": kernels / steps,
        "busy_us_per_step": busy / steps,
        "busy_share": busy / steps / (ms * 1e3),
        "busy_share_profiled": busy / (wall_prof * 1e6),
    }


# the JAX test's super-droplets, at which its RH_ice < 1.1 at the end holds
SPICHTINGER_TEST_N = 32


def _spichtinger(backend, gpu, n_sd=ICE_N, steps=SPICHTINGER_STEPS):
    """phase 25: ``spichtinger_et_al_2023.Simulation`` at ``n_sd`` with w = 5
    m/s and T0 = 220 K (``TestSpichtingerEtAl2023``), ``Simulation.run`` over
    ``steps`` steps with K3's and K4's counts set to 0 just before and read
    just after: the two tests' assertions, the total water to 1e-5. The test's RH_ice < 1.1
    at the end is a property of its 32 super-droplets (one of which, frozen,
    is 3% of the drops): at 2^14 the float64 CPU runs end at 1.18 (the JAX
    package) and 1.26 (the port), with 4.5e7 and 2.7e7 crystals per m^3
    where 32 super-droplets make 1.3e9, so above ``SPICHTINGER_TEST_N`` the phase asserts that the
    burst lowered RH_ice from its peak and prints where it ends. At
    ``ICE_N``, 20 more steps timed and 20 under the profiler (the device's
    busy share). Returns (K3 launches, the per-step record)"""
    import numpy as np

    from pysdm_tpu_torch.models import spichtinger_et_al_2023 as model
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    settings = model.Settings(n_sd=n_sd, w_updraft=5.0, T0=220.0, seed=44, dt=1.0)
    sim = model.Simulation(settings, backend_class=backend)
    p = sim.particulator
    m_d = settings.mass_of_dry_air
    water0 = _total_water(p, m_d)
    solver = p.dynamics["Condensation"].solver
    k3.masses_new.launches = 0
    scan.cumsum.launches = 0
    solves0, reads0 = solver.substep_solves, solver.host_reads
    t0 = time.perf_counter()
    out = sim.run(n_steps=steps, steps_per_output=20)
    p.block_until_ready()
    wall = time.perf_counter() - t0
    launches, k4 = k3.masses_new.launches, scan.cumsum.launches
    solves, reads = solver.substep_solves - solves0, solver.host_reads - reads0
    if p.device.type == "cuda" and not (launches == solves >= steps):
        raise AssertionError(f"phase 25: {launches} K3 launches, {solves} solves")
    if k4 != 0:
        raise AssertionError(f"phase 25: a one-cell parcel launched K4 {k4} times")
    drift = (_total_water(p, m_d) - water0) / water0
    n_max = settings.N_dv_solution_droplet
    checks = {
        "RH_ice starts at 1": abs(out["RH_ice"][0] - 1) < 1e-6,
        "peak RH_ice in 1.4-1.7": 1.4 < np.nanmax(out["RH_ice"]) < 1.7,
        "RH_ice ends below 1.1": (
            out["RH_ice"][-1] < 1.1 if n_sd == SPICHTINGER_TEST_N
            else out["RH_ice"][-1] < np.nanmax(out["RH_ice"])
        ),
        "no ice at first": out["n_i"][0] == 0,
        "ice crystals above 1e6 /m^3": out["n_i"][-1] > 1e6,
        "crystals within the droplets": out["n_i"][-1] <= n_max * 1.01,
        "qi never falls": (np.diff(out["qi"][out["qi"] > 0]) >= -1e-18).all(),
        "qi at the end": out["qi"][-1] > 0,
        "total water to 1e-5": abs(drift) < 1e-5,
        "condensation succeeded": p.get_counter("condensation_success").all(),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 25: {failed}: {out}, drift {drift}")
    record = {
        "ms_per_step": wall / steps * 1e3,
        "k3_launches_per_step": launches / steps,
        "host_reads_per_step": reads / steps,
    }
    print(f"phase 25: Spichtinger et al. 2023 parcel, {n_sd} super-droplets,"
          f" Simulation.run of {steps} steps (21 product reads) in {wall!r} s:"
          f" {record['ms_per_step']!r} ms/step, {launches} K3 launches ="
          f" solves ({record['k3_launches_per_step']!r}/step), no K4,"
          f" {record['host_reads_per_step']!r} host reads/step; peak RH_ice"
          f" {float(np.nanmax(out['RH_ice']))!r}, at the end"
          f" {float(out['RH_ice'][-1])!r}, at t = 0"
          f" {float(out['RH_ice'][0])!r}; n_i {float(out['n_i'][-1])!r}"
          f" /m^3, qi {float(out['qi'][-1])!r} kg/kg, total water drift"
          f" {drift!r} [{gpu}]")
    if p.device.type != "cuda" or n_sd != ICE_N:
        return launches, record
    p.run(1)
    launches0, reads0 = k3.masses_new.launches, solver.host_reads
    prof = _profile_steps(p, 20, "spichtinger")
    record["ms_per_step_without_products"] = prof["ms_per_step"]
    for key in ("kernels_per_step", "busy_share", "busy_share_profiled"):
        record[key] = prof[key]
    print(f"phase 25: after the burst, 20 steps: {record['ms_per_step_without_products']!r}"
          f" ms/step, {(k3.masses_new.launches - launches0) / 40!r} K3 launches/step,"
          f" {(solver.host_reads - reads0) / 40!r} host reads/step,"
          f" {record['kernels_per_step']!r} kernels/step, the device busy"
          f" {prof['busy_us_per_step']!r} us/step: {record['busy_share']!r} of the unprofiled"
          f" and {record['busy_share_profiled']!r} of the profiled wall time [{gpu}]")
    return launches, record


# the JAX test's super-droplets, at which its liquid cloud forms before the
# ice
ABADE_TEST_N = 64


def _abade(backend, gpu, n_sd=ICE_N, steps=ABADE_STEPS):
    """phase 26: ``abade_and_albuquerque_2024.Simulation`` at ``n_sd``
    (dt = 10 s, seed 44), ``Simulation.run`` of ``steps`` steps, outputs
    every 50: the assertions of ``TestAbadeAndAlbuquerque2024`` (a liquid
    cloud, then glaciation between -15 and -35 C, the vapour depleted), K3
    launches = solves, no K4; and the test's toggles (no freezing, no
    deposition: no ice) over 50 steps. The liquid cloud (peak above 1e-4
    kg/kg) is asserted at the test's ``ABADE_TEST_N`` super-droplets only:
    at 2^17 the sampled freezing temperatures reach the spectrum's warm
    tail (an INP freezing at ~260 K, at cloud base), and the first
    crystal's explicit log-coordinate step takes the cell's whole vapour
    excess over ice saturation (the deposition's limiter), so the parcel
    glaciates without a liquid cloud; the peak is printed. Returns the K3
    launches"""
    import numpy as np

    from pysdm_tpu_torch.models import abade_and_albuquerque_2024 as model
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    sim = model.Simulation(
        model.Settings(n_sd=n_sd, timestep=10.0, seed=44), backend_class=backend
    )
    p = sim.particulator
    solver = p.dynamics["Condensation"].solver
    k3.masses_new.launches = 0
    scan.cumsum.launches = 0
    solves0, reads0 = solver.substep_solves, solver.host_reads
    t0 = time.perf_counter()
    out = sim.run(nt=steps, steps_per_output_interval=50)["products"]
    p.block_until_ready()
    wall = time.perf_counter() - t0
    launches = k3.masses_new.launches
    solves = solver.substep_solves - solves0
    if p.device.type == "cuda" and not (launches == solves >= steps):
        raise AssertionError(f"phase 26: {launches} K3 launches, {solves} solves")
    if scan.cumsum.launches != 0:
        raise AssertionError("phase 26: a one-cell parcel launched K4")
    water, ice, T = out["water"], out["ice"], out["T"]
    first_ice = int(np.argmax(ice > 0))
    checks = {
        "no cloud at first": water[0] < 1e-8,
        "a liquid cloud": water.max() > 1e-4 or n_sd != ABADE_TEST_N,
        "ice grows past the liquid peak": ice[np.argmax(water)] < ice[-1],
        "ice above 1e-3": ice[-1] > 1e-3,
        "the liquid gone": water[-1] < 1e-6,
        "vapour depleted": out["vapour"][-1] < 0.3 * out["vapour"][0],
        "freezing onset in 238-260 K": 238 < T[first_ice] < 260,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 26: {failed}: {out}")
    toggled = model.Simulation(
        model.Settings(n_sd=n_sd, timestep=10.0, enable_immersion_freezing=False,
                       enable_vapour_deposition_on_ice=False),
        backend_class=backend,
    ).run(nt=50, steps_per_output_interval=25)["products"]
    if not (toggled["ice"] == 0).all():
        raise AssertionError("phase 26: ice without freezing")
    print(f"phase 26: Abade & Albuquerque 2024 parcel, {n_sd} super-droplets,"
          f" {steps} steps in {wall!r} s ({wall / steps * 1e3!r} ms/step),"
          f" {launches} K3 launches = solves, {(solver.host_reads - reads0) / steps!r}"
          f" host reads/step: liquid peak {float(water.max())!r} kg/kg, ice"
          f" {float(ice[-1])!r} kg/kg at the end, liquid {float(water[-1])!r},"
          f" first ice at T = {float(T[first_ice])!r} K; the toggles' run"
          f" made no ice [{gpu}]")
    return launches


def _niedermeier(backend, gpu):
    """phase 27: ``niedermeier_et_al_2014.Simulation`` with the settings of
    ``TestNiedermeier2014::test_immersion_freezing_produces_ice`` (J_het =
    1e12, T0 = 250 K, dt = 5 s, 5 CCN bins and 4 IN super-particles, 300
    steps): no ice at first, ice at the end, the parcel cooled. Returns the
    K3 launches"""
    import numpy as np

    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.models import niedermeier_et_al_2014 as model
    from pysdm_tpu_torch.ops.cuda import condensation as k3

    settings = model.Settings(
        formulae=Formulae(
            seed=44, particle_shape_and_density="MixedPhaseSpheres",
            heterogeneous_ice_nucleation_rate="Constant",
            constants={"J_HET": 1e12},
        ),
        initial_temperature=250.0, timestep=5.0, ccn_sampling_n=5,
        in_sampling_n=4,
    )
    sim = model.Simulation(settings, backend_class=backend)
    k3.masses_new.launches = 0
    t0 = time.perf_counter()
    out = sim.run()
    wall = time.perf_counter() - t0
    launches = k3.masses_new.launches
    iwc, T = np.asarray(out["ice water content"]), np.asarray(out["T"])
    if sim.particulator.device.type == "cuda" and launches < sim.steps:
        raise AssertionError(f"phase 27: {launches} K3 launches")
    if not (iwc[0] == 0.0 and iwc[-1] > 0.0 and T[-1] < T[0]):
        raise AssertionError(f"phase 27: iwc {iwc[0]} -> {iwc[-1]}, T {T[0]} -> {T[-1]}")
    print(f"phase 27: Niedermeier et al. 2014 parcel, {sim.particulator.n_sd}"
          f" super-particles, {sim.steps} steps in {wall!r} s, {launches} K3"
          f" launches: ice water content {float(iwc[-1])!r} kg/m^3 at the end,"
          f" T {float(T[0])!r} -> {float(T[-1])!r} K [{gpu}]")
    return launches


def _float32_ice_records(backend, gpu, n_sd=ICE_N, steps=100):
    """phase 28: float32 on the card against float64 on the CPU: the
    largest |Delta log10 J_hom| of the three Koop variants over their
    admitted ranges (``KOOP_DA_W_ICE``, ``KOOP_MURRAY_T``); and, along the
    first ``steps`` steps of the Spichtinger parcel at ``n_sd`` (through
    the burst), the drops whose freezing probability 1 - exp(-J_hom V dt)
    is positive in float64 and zero in float32"""
    import numpy as np
    import torch

    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.models import spichtinger_et_al_2023 as model
    from pysdm_tpu_torch.ops import freezing as frz_ops

    device = backend(Formulae()).device
    records = {}
    for variant in ("Koop2000", "Koop_Correction", "KoopMurray2016"):
        f = Formulae(homogeneous_ice_nucleation_rate=variant)
        da = np.linspace(*KOOP_DA_W_ICE, 4001)
        T = np.linspace(*KOOP_MURRAY_T, 4001)
        j = [
            f.homogeneous_ice_nucleation_rate.j_hom(
                torch.as_tensor(T, dtype=dtype, device=dev),
                torch.as_tensor(da, dtype=dtype, device=dev),
            ).double().cpu().numpy()
            for dtype, dev in ((torch.float32, device), (torch.float64, "cpu"))
        ]
        if not (np.isfinite(j[0]).all() and (j[0] > 0).all()):
            raise AssertionError(f"phase 28: {variant}: J_hom not finite")
        records[variant] = float(np.max(np.abs(np.log10(j[0]) - np.log10(j[1]))))
    settings = model.Settings(n_sd=n_sd, w_updraft=5.0, T0=220.0, seed=44, dt=1.0)
    p = model.Simulation(settings, backend_class=backend).particulator
    f = p.formulae
    zero_in_f32, positive, worst_step = 0, 0, (0, 0)
    for step in range(steps):
        p.run(1)
        env = {k: torch.as_tensor(p.get_env(k)) for k in ("T", "RH")}
        mass = torch.as_tensor(p.attributes["signed water mass"])
        probs = []
        for dtype, dev in ((torch.float32, device), (torch.float64, "cpu")):
            T, RH = (env[k].to(dtype=dtype, device=dev) for k in ("T", "RH"))
            m = mass.to(dtype=dtype, device=dev)
            a_w_ice, RH_ice = frz_ops.a_w_ice_and_rh_ice(f, T, RH)
            da = (RH_ice - 1.0) * a_w_ice
            rate = f.homogeneous_ice_nucleation_rate.j_hom(
                T, f.homogeneous_ice_nucleation_rate.d_a_w_ice_maximum(da)
            ) * f.particle_shape_and_density.mass_to_volume(m.abs())
            prob = 1.0 - f.trivia.poissonian_avoidance_function(rate, settings.dt)
            candidate = (m > 0) & f.homogeneous_ice_nucleation_rate.d_a_w_ice_within_range(da)
            probs.append(torch.where(candidate, prob, 0.0).double().cpu().numpy())
        lost = int(((probs[0] == 0) & (probs[1] > 0)).sum())
        zero_in_f32 += lost
        positive += int((probs[1] > 0).sum())
        worst_step = max(worst_step, (lost, step + 1))
    records["zero_in_float32"] = zero_in_f32
    records["positive_in_float64"] = positive
    print(f"phase 28: float32 on {device} against float64 on the CPU: largest"
          f" |Delta log10 J_hom| over Delta a_w in {KOOP_DA_W_ICE}:"
          f" Koop2000 {records['Koop2000']!r}, Koop_Correction"
          f" {records['Koop_Correction']!r}; over T in {KOOP_MURRAY_T} K:"
          f" KoopMurray2016 {records['KoopMurray2016']!r}. Spichtinger parcel,"
          f" {n_sd} drops, steps 1-{steps}: {zero_in_f32} drop-steps with a"
          f" freezing probability positive in float64 and zero in float32,"
          f" of {positive} positive (most, {worst_step[0]}, at step"
          f" {worst_step[1]}) [{gpu}]")
    return records


# the general collision path (phases 29-32): Berry 1967's own width and
# length, config #2's bench width for the Straub box, Bieli's own width
BERRY_ROWS_N = 2**13
BERRY_ROWS_STEPS = 1800
# the adaptive Berry run that takes K1a with the values given (phase 30)
BERRY_ADAPTIVE_STEPS = 100
STRAUB_N = 2**17
STRAUB_STEPS = 100
PROFILED_STEPS = 10
# card against a float64 CPU run of the port at the same seed (the two
# draw other random numbers): the number of the Straub box at 50 and 100 s,
# three times the larger difference of two CPU seeds at 2^17 (2.6% and
# 4.5%); Bieli's M0 and M2 after 59 steps, five standard deviations of the
# difference of two runs, from 16 CPU seeds at 2^12 (std 0.9-1.8% in M0,
# 4.0-4.5% in M2, the largest drops' noise)
STRAUB_NUMBER_RTOL = 0.15
BIELI_MOMENT_RTOL = {"M0": 0.13, "M2": 0.32}


def berry_kernel_args(torch, n, seed, device, kernel="Hydrodynamic"):
    """the arguments of K1a and of its Parameterized form on Berry 1967's
    state at ``n`` super-droplets (its ``run`` with no step, on the card),
    at one random K and one u01 row: (K1a's: the multiplicities and the
    extensive rows, the Berry kernel's values times the normalization
    (``mirror_normalization_factor``, dt = 1 s) as the float32 kernel x norm
    row, the u01 row, K; the Parameterized form's: the state, the radius
    and fall-velocity rows, the kernel's parameters, the normalization as
    the (1,) scale, the u01 row, K), the rows in the state's float type"""
    import numpy as np

    from pysdm_tpu_torch.dynamics.collisions import collision_kernels
    from pysdm_tpu_torch.models import berry_1967
    from pysdm_tpu_torch.ops.pairing import MirrorPairing

    settings = berry_1967.Settings(steps=[0])
    settings.n_sd = n
    _, p = berry_1967.run(settings)
    rng = np.random.default_rng(seed)
    K = int(rng.integers(0, n))
    particles = p.sim_state["particles"]
    pairing = MirrorPairing(K, n, particles.alive)
    attrs = {
        name: p.get_attribute(name)
        for name in ("radius", "relative fall velocity")
    }
    instance = getattr(collision_kernels, kernel)()
    values = instance.pairwise(
        p.formulae, attrs, {k: pairing.partner(v) for k, v in attrs.items()}
    )
    norm = settings.dt / settings.dv * n
    kernnorm = (values * norm).to(torch.float32)
    u01 = torch.as_tensor(rng.uniform(size=n), dtype=torch.float32, device=device)
    scale = torch.full((1,), norm, dtype=attrs["radius"].dtype, device=device)
    state = (particles.multiplicity, particles.extensive)
    return (
        (*state, kernnorm, u01, K),
        (*state, attrs["radius"], attrs["relative fall velocity"],
         instance.params, scale, u01, K),
    )


def k1a_args(torch, n, seed, device, kernel="Hydrodynamic"):
    """K1a's arguments on Berry 1967's state (``berry_kernel_args``)"""
    return berry_kernel_args(torch, n, seed, device, kernel)[0]


def k1a_random_args(torch, n, ext_dtype, seed, device):
    """K1a's arguments on a random state (``_random_state``: multiplicities
    up to 2^40, dead slots, ties), kernel x norm rows that give up to ~8
    collisions a pair"""
    import numpy as np

    K = (n // 3) * 2
    mult, ext, _ = _random_state(torch, n, K, ext_dtype, seed, device)
    rng = np.random.default_rng(seed + 1)
    kernnorm = torch.as_tensor(
        rng.uniform(0.0, 8.0, n) / 2**40, dtype=torch.float32, device=device
    )
    u01 = torch.as_tensor(rng.uniform(size=n), dtype=torch.float32, device=device)
    return (mult, ext, kernnorm, u01, K)


def _source_constant(source, name):
    """the value of ``constexpr int <name> = <value>;`` in the
    ``pysdm_tpu_torch/csrc`` source the kernels were built from"""
    import re

    from pysdm_tpu_torch.ops.cuda import _build

    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _leaders(n, K):
    """the count of the mirror croupier's pairs at n slots and offset K,
    one a leader slot"""
    from pysdm_tpu_torch.ops.cuda.collision import mirror_pairs

    return mirror_pairs(n, int(K))[0].numel()


def k1a_bytes(args):
    """the bytes K1a must move: the multiplicities and the extensive rows
    read and written, the kernel x norm and u01 rows read at the pairs'
    leaders only"""
    mult, ext, kernnorm, u01, K = args
    leaders = _leaders(mult.numel(), K)
    return (
        2 * mult.numel() * mult.element_size()
        + 2 * ext.numel() * ext.element_size()
        + leaders * (kernnorm.element_size() + u01.element_size())
    )


def k1p_bytes(args):
    """the bytes K1a's Parameterized form must move: the multiplicities and
    the extensive rows read and written, the radius and fall-velocity rows
    read at both slots of a pair, the u01 row at the pairs' leaders only"""
    mult, ext, radius, fall, _, _, u01, K = args
    return (
        2 * mult.numel() * mult.element_size()
        + 2 * ext.numel() * ext.element_size()
        + sum(t.numel() * t.element_size() for t in (radius, fall))
        + _leaders(mult.numel(), K) * u01.element_size()
    )


def _check_k1p(torch, kern, args, label):
    """K1a's Parameterized form against its twin on ``args``, as
    ``_check_k1a`` holds K1a"""
    import numpy as np

    before = kern.coalesce_mirror_parameterized.launches
    got = kern.coalesce_mirror_parameterized(*args)
    torch.cuda.synchronize()
    if kern.coalesce_mirror_parameterized.launches != before + 1:
        raise AssertionError(f"{label}: the launch counter did not count")
    want = kern.coalesce_mirror_parameterized_reference(*args)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(
            f"{label}: K1a's Parameterized form differs from its twin"
            f" ({int((got[0] != want[0]).sum())} multiplicities)"
        )
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-5)
    err = float((got[1].double() - want[1].double()).abs().max())
    return err, int((got[0] != args[0]).sum())


def _check_k1a(torch, kern, args, label):
    """K1a against its twin on ``args``: multiplicities and extensive rows
    bit-equal, the three rate sums to rtol 1e-5 (another summation order);
    returns (max_abs_err of the rows, slots changed)"""
    import numpy as np

    before = kern.coalesce_mirror_rows.launches
    got = kern.coalesce_mirror_rows(*args)
    torch.cuda.synchronize()
    if kern.coalesce_mirror_rows.launches != before + 1:
        raise AssertionError(f"{label}: the launch counter did not count")
    want = kern.coalesce_mirror_rows_reference(*args)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{label}: K1a differs from its twin")
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-5)
    err = float((got[1].double() - want[1].double()).abs().max())
    return err, int((got[0] != args[0]).sum())


def _k1a_vs_twin(torch, kern, device, gpu):
    """phase 29: K1a and its Parameterized form against their twins on the
    card, bit for bit in multiplicities and rows: on Berry 1967's state
    with Hydrodynamic's kernel (K1a: its x norm row) at 2^13 (the model's
    width, the main path's shape) and 2^20, K1a also on random states at
    2^20 with float32 and float64 rows; three launches on the same inputs
    bit-equal, and two streams at once, K1a's at 2^20 and the Parameterized
    form's at both widths; then the device time of each and its twin at
    both widths, K1a at 2^20 also over a rotation of eight inputs. Returns
    (max_abs_err, {n: (ms, twin ms, bytes)}, rotated ms at 2^20,
    {"max_abs_err": .., "times": {n: (ms, twin ms, bytes)}} of the
    Parameterized form)"""
    import numpy as np

    max_abs_err = k1p_err = 0.0
    berry_args, k1p_args = {}, {}
    for n in (BERRY_ROWS_N, N_MAIN):
        berry_args[n], k1p_args[n] = berry_kernel_args(torch, n, n, device)
        err, changed = _check_k1a(torch, kern, berry_args[n], f"phase 29 n={n}")
        max_abs_err = max(max_abs_err, err)
        err, changed_p = _check_k1p(torch, kern, k1p_args[n],
                                    f"phase 29 Parameterized n={n}")
        k1p_err = max(k1p_err, err)
        if changed_p != changed:
            raise AssertionError(f"phase 29 n={n}: {changed_p} slots changed"
                                 f" by the Parameterized form, {changed} by K1a")
        print(f"phase 29: K1a and its Parameterized form on Berry 1967's"
              f" state with Hydrodynamic, n={n}:"
              f" xi and rows bit-equal to the twins, {changed} slots"
              f" changed, {int((berry_args[n][2] > 0).sum())} slots with a"
              f" kernel value above 0")
    for ext_dtype in (np.float32, np.float64):
        random_args = k1a_random_args(torch, N_MAIN, ext_dtype, 7, device)
        err, changed = _check_k1a(torch, kern, random_args, "phase 29 random")
        max_abs_err = max(max_abs_err, err)
        if not changed > N_MAIN // 20:
            raise AssertionError(f"phase 29: {changed} slots changed")
        print(f"phase 29: K1a on a random state, n={N_MAIN},"
              f" ext={np.dtype(ext_dtype).name}: bit-equal to the twin,"
              f" {changed} slots changed")
    inputs = [berry_args[N_MAIN]] + [
        k1a_random_args(torch, N_MAIN, np.float32, seed, device)
        for seed in range(1, 8)
    ]
    check_deterministic(torch, kern.coalesce_mirror_rows, inputs[:2], "phase 29: K1a")
    for n, args in k1p_args.items():
        # the second input: the same state paired at another K
        check_deterministic(torch, kern.coalesce_mirror_parameterized,
                            [args, (*args[:-1], (args[-1] + 1) % n)],
                            f"phase 29: K1a's Parameterized form n={n}")
    times, k1p_times = {}, {}
    for n, args in berry_args.items():
        times[n] = (
            _time_ms(torch, lambda a=args: kern.coalesce_mirror_rows(*a), 200),
            _time_ms(
                torch, lambda a=args: kern.coalesce_mirror_rows_reference(*a), 10
            ),
            k1a_bytes(args),
        )
        args = k1p_args[n]
        k1p_times[n] = (
            _time_ms(torch,
                     lambda a=args: kern.coalesce_mirror_parameterized(*a), 200),
            _time_ms(torch, lambda a=args:
                     kern.coalesce_mirror_parameterized_reference(*a), 10),
            k1p_bytes(args),
        )
    rotated_ms = _time_rotated_ms(
        torch, lambda a: kern.coalesce_mirror_rows(*a), inputs, 200
    )
    rows = berry_args[N_MAIN][1]
    for label, table in (("K1a", times), ("its Parameterized form", k1p_times)):
        print(f"phase 29: {label} with Hydrodynamic ({rows.shape[0]}"
              f" {rows.dtype} extensive rows): " + "; ".join(
                  f"n={n}: {t[0]!r} ms, plain twin {t[1]!r} ms, bound"
                  f" {bound_ms(t[2])[0]!r} ms ({t[2]} B)"
                  for n, t in table.items()
              ) + f" [{gpu}]")
    print(f"phase 29: K1a at n={N_MAIN} over a rotation of {len(inputs)}"
          f" inputs {rotated_ms!r} ms [{gpu}]")
    return max_abs_err, times, rotated_ms, {
        "max_abs_err": k1p_err, "times": k1p_times,
    }


def _berry_kernels_model(kern, gpu):
    """phase 30: ``berry_1967.run`` with ``settings.kernel`` set to
    ``Hydrodynamic`` and to ``Electric`` at the model's own 2^13
    super-droplets and 1800 steps on the card, the launch counts set to 0
    just before each run and read just after: launches of K1a's
    Parameterized form = substeps = 1800 and none of K1a with the values
    given, the liquid conserved to 1e-6, the number-weighted mean radius of
    dv/dlnr grows; the run's first substep held to its twin; ms/step, host
    reads and device kernels a step (profiled over 5 more steps). Then
    ``BERRY_ADAPTIVE_STEPS`` adaptive steps with Hydrodynamic from the
    model's start, whose substep choice reads the kernel's values and hands
    them to K1a as a row: K1a launches = substeps, the first held to its
    twin. Returns (launches of the Parameterized form over the two runs,
    K1a's over the adaptive one, the records)"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.dynamics.collisions import collision, collision_kernels
    from pysdm_tpu_torch.models import berry_1967 as model

    launches_total, records = 0, {}
    for kernel in ("Hydrodynamic", "Electric"):
        settings = model.Settings(steps=[0, 600, 1200, BERRY_ROWS_STEPS])
        settings.n_sd = BERRY_ROWS_N
        settings.kernel = getattr(collision_kernels, kernel)()
        with _capturing_builder(model) as built, _keeping_calls(
            collision, "coalesce_mirror_parameterized", lambda i: i == 0,
            limit=1,
        ) as first:
            kern.coalesce_mirror_parameterized.launches = 0
            kern.coalesce_mirror_rows.launches = 0
            t0 = time.perf_counter()
            vals, p = model.run(settings)
            p.block_until_ready()
            wall = time.perf_counter() - t0
            launches = kern.coalesce_mirror_parameterized.launches
            rows_launches = kern.coalesce_mirror_rows.launches
        dyn = p.dynamics["Collision"]
        liquid0, liquid1 = built[0][1], _totals(p)[0]
        r_mid = np.sqrt(settings.radius_bins_edges[:-1] * settings.radius_bins_edges[1:])
        mean_r = [float((vals[s] * r_mid).sum() / vals[s].sum())
                  for s in settings.output_steps]
        checks = {
            "on the card": p.device.type == "cuda" and built[0][0] is p,
            "route": dyn.route() == "rows",
            "Parameterized form launches = substeps":
                launches == dyn.substeps_run == BERRY_ROWS_STEPS,
            "no K1a launch with the values given": rows_launches == 0,
            "liquid": abs(liquid1 - liquid0) <= 1e-6 * liquid0,
            "growth": mean_r[-1] > mean_r[0],
            "rates": float(p.get_counter("coalescence_rate").sum()) > 0,
        }
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(
                f"phase 30: {kernel}: {failed}: {launches} launches"
                f" ({rows_launches} of K1a), {dyn.substeps_run} substeps,"
                f" liquid {liquid0} -> {liquid1}, mean radius {mean_r}"
            )
        launches_total += launches
        args, _ = first[0]
        _, first_changed = _check_k1p(torch, kern, args, "phase 30")
        reads0 = dyn.host_reads
        prof = _profile_steps(p, PROFILED_STEPS, f"berry_{kernel}")
        ms, kernels, busy = (
            prof["ms_per_step"], prof["kernels_per_step"], prof["busy_share"]
        )
        reads = dyn.host_reads - reads0
        records[kernel] = {"wall_s": wall, "launches": launches, **prof}
        print(f"phase 30: berry_1967.run with {kernel} at n_sd={BERRY_ROWS_N}"
              f" on the card: {BERRY_ROWS_STEPS} steps in {wall!r} s"
              f" ({wall / BERRY_ROWS_STEPS * 1e3!r} ms/step with the build"
              f" and 4 product reads), {launches} launches of K1a's"
              f" Parameterized form = substeps, {rows_launches} of K1a;"
              f" {PROFILED_STEPS} more steps: {ms!r} ms/step, {reads} host"
              f" reads in {2 * PROFILED_STEPS} steps, {kernels!r} device"
              f" kernels/step, busy {busy!r}; mean radius of dv/dlnr {mean_r} m; liquid"
              f" drift {(liquid1 - liquid0) / liquid0!r}; coalescence rate"
              f" {float(p.get_counter('coalescence_rate').sum())!r}; the"
              f" run's first substep bit-equal to the twin ({first_changed}"
              f" slots changed) [{gpu}]")
    settings = model.Settings(steps=[0, BERRY_ADAPTIVE_STEPS])
    settings.n_sd = BERRY_ROWS_N
    settings.kernel = collision_kernels.Hydrodynamic()
    settings.adaptive = True
    with _keeping_calls(collision, "coalesce_mirror_rows", lambda i: i == 0,
                        limit=1) as first:
        kern.coalesce_mirror_parameterized.launches = 0
        kern.coalesce_mirror_rows.launches = 0
        t0 = time.perf_counter()
        _, p = model.run(settings)
        p.block_until_ready()
        wall = time.perf_counter() - t0
        rows_launches = kern.coalesce_mirror_rows.launches
        launches = kern.coalesce_mirror_parameterized.launches
    dyn = p.dynamics["Collision"]
    if not (p.device.type == "cuda" and rows_launches == dyn.substeps_run
            >= BERRY_ADAPTIVE_STEPS and launches == 0):
        raise AssertionError(
            f"phase 30: adaptive Hydrodynamic: {rows_launches} K1a launches,"
            f" {launches} of the Parameterized form, {dyn.substeps_run}"
            f" substeps"
        )
    args, _ = first[0]
    _, first_changed = _check_k1a(torch, kern, args, "phase 30 adaptive")
    records["adaptive"] = {"wall_s": wall, "launches": rows_launches}
    print(f"phase 30: berry_1967.run with Hydrodynamic, adaptive, at"
          f" n_sd={BERRY_ROWS_N}: {BERRY_ADAPTIVE_STEPS} steps in {wall!r} s,"
          f" {rows_launches} K1a launches = substeps, the first held to its"
          f" twin bit for bit ({first_changed} slots changed) [{gpu}]")
    return launches_total, rows_launches, records


def straub_settings(model, n_sd, handle_all_breakups=False):
    """de Jong/Mackay 2023's ``Settings0D`` with Straub 2010's fragments
    (vmin = (1 um)^3, nfmax = 100) and coalescence efficiency, the paper's
    Straub configuration, at ``n_sd``; with ``handle_all_breakups`` the
    formulae are rebuilt with it"""
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.dynamics.collisions.breakup_fragmentations import (
        Straub2010Nf,
    )
    from pysdm_tpu_torch.dynamics.collisions.coalescence_efficiencies import (
        Straub2010Ec,
    )

    settings = model.Settings0D(
        fragmentation=Straub2010Nf(vmin=(1e-6) ** 3, nfmax=100)
    )
    settings.coal_eff = Straub2010Ec()
    settings.n_sd = n_sd
    if handle_all_breakups:
        settings.formulae = Formulae(
            seed=settings.seed, fragmentation_function="Straub2010Nf",
            handle_all_breakups=True,
        )
    return settings


def build_straub_box(n_sd, backend, croupier=None):
    """the Straub box (``straub_settings``) built as ``build_breakup_box``
    builds config #2, with ``Collision(..., croupier=croupier)``"""
    from pysdm_tpu_torch import Builder
    from pysdm_tpu_torch.dynamics import Collision
    from pysdm_tpu_torch.environments import Box
    from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu_torch.models import dejong_mackay_et_al_2023 as model

    s = straub_settings(model, n_sd)
    builder = Builder(
        n_sd=n_sd, backend=backend(s.formulae), environment=Box(dv=s.dv, dt=s.dt)
    )
    builder.add_dynamic(Collision(
        collision_kernel=s.kernel, coalescence_efficiency=s.coal_eff,
        breakup_efficiency=s.break_eff, fragmentation_function=s.fragmentation,
        adaptive=s.adaptive, croupier=croupier,
    ))
    attributes = {}
    attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
        s.spectrum
    ).sample(n_sd)
    return builder.build(attributes)


def _rates_ok(p, label):
    """every rate counter finite and non-negative; returns their sums"""
    import numpy as np

    rates = {}
    for name in ("collision_rate", "collision_rate_deficit", "coalescence_rate",
                 "breakup_rate", "breakup_rate_deficit"):
        value = p.get_counter(name).astype(float)
        if not (np.isfinite(value).all() and (value >= 0).all()):
            raise AssertionError(f"{label}: {name} {value}")
        rates[name] = float(value.sum())
    return rates


def _k4_on_sort_croupier_step(p, launches, rows, gpu):
    """phase 31 on the sort croupier, after the counted run (``launches``
    and ``rows`` of K4 in it): one more step with every scan it gives K4
    captured, then K4 on each against its twin (``_k4_on_scans``). Returns
    K4's record of this path"""
    import torch

    from pysdm_tpu_torch.ops import segments

    captured = []
    real_k4 = segments.cumsum

    def capture_k4(x):
        captured.append(x.clone())
        return real_k4(x)

    dyn = p.dynamics["Collision"]
    substeps = dyn.substeps_run
    with _replaced(segments, "cumsum", capture_k4):
        p.run(1)
    substeps = dyn.substeps_run - substeps
    if not captured:
        raise AssertionError("phase 31: the sort croupier's step gave K4 nothing")
    err, seen = _k4_on_scans(real_k4, captured, "phase 31 sort croupier")
    shapes = sorted({line.split(":")[0] for line in seen})
    print(f"phase 31: K4 on the sort croupier: {launches} launches ({rows}"
          f" rows) in the counted run; one more step ({substeps} substeps)"
          f" gave it {len(captured)} scans of {shapes}, each within 1e-5 of"
          f" its float64 prefix (integers equal to torch.cumsum), max abs"
          f" err {err!r} [{gpu}]")
    return {
        "launches": launches,
        "rows": rows,
        "max_abs_err": err,
        "scans_in_one_step": len(captured),
        "n": max(x.shape[-1] for x in captured),
        "dtypes": sorted({str(x.dtype) for x in captured}),
        "int_scans": sum(not torch.is_floating_point(x) for x in captured),
    }


def _straub_on_card(gpu):
    """phase 31: de Jong/Mackay 2023's box with Straub 2010 (the float64
    breakup path) at config #2's 2^17 super-droplets, adaptive, through
    ``run_box_breakup`` for 100 steps, again with ``handle_all_breakups``,
    and through a builder on the sort croupier: the liquid conserved to
    1e-6, rates finite and non-negative, breakups; ms/step, host reads and
    device kernels a step; on the sort croupier K4's count set to 0 just
    before the run and read just after, and K4 held to its twin on the
    scans of one more step (``_k4_on_sort_croupier_step``); then the first
    run's spectra against a float64 CPU run of the port at the same seed,
    statistically: number and liquid under dv/dlnr at 50 and 100 s, the
    number within ``STRAUB_NUMBER_RTOL`` (the spread of two CPU seeds is
    below a third of it). Returns ({variant: record}, K4's record)"""
    import numpy as np

    from pysdm_tpu_torch.backends import CPU, GPU
    from pysdm_tpu_torch.models import dejong_mackay_et_al_2023 as model
    from pysdm_tpu_torch.ops.cuda import scan

    records = {}
    outs = {}
    for variant in ("closed form", "handle_all_breakups", "sort croupier"):
        steps = [0, STRAUB_STEPS // 2, STRAUB_STEPS]
        with _capturing_builder(model) as built:
            t0 = time.perf_counter()
            if variant == "sort croupier":
                p = build_straub_box(STRAUB_N, GPU, croupier="sort")
                built.append((p, _totals(p)[0]))
                scan.cumsum.launches = 0
                scan.cumsum.rows = 0
                p.run(STRAUB_STEPS)
                k4_launches = scan.cumsum.launches
                k4_rows = scan.cumsum.rows
                out = None
            else:
                settings = straub_settings(
                    model, STRAUB_N, variant == "handle_all_breakups"
                )
                out = model.run_box_breakup(settings, steps=steps, return_nv=True)
                p = out.core
            p.block_until_ready()
            wall = time.perf_counter() - t0
        dyn = p.dynamics["Collision"]
        liquid0, liquid1 = built[0][1], _totals(p)[0]
        rates = _rates_ok(p, f"phase 31 {variant}")
        if out is not None:
            # the rate products reset their counters on each read: the
            # model's reads at the output steps hold the sums
            read = out.rates.sum(axis=0)
            if not (np.isfinite(out.rates).all() and (out.rates >= 0).all()):
                raise AssertionError(f"phase 31: {variant}: rates {out.rates}")
            rates.update(zip(
                ("collision_rate", "collision_rate_deficit",
                 "coalescence_rate", "breakup_rate"), map(float, read),
            ))
        checks = {
            "on the card": p.device.type == "cuda",
            "route": dyn.route() == "float64",
            "liquid": abs(liquid1 - liquid0) <= 1e-6 * liquid0,
            "breakups": rates["breakup_rate"] > 0 and rates["coalescence_rate"] > 0,
            "spectra": out is None or (
                np.isfinite(out.y).all() and np.isfinite(out.y2).all()
            ),
        }
        if variant == "sort croupier":
            checks["K4 launched"] = k4_launches > 0
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(
                f"phase 31: {variant}: {failed}: liquid {liquid0} -> {liquid1},"
                f" rates {rates}"
            )
        reads, substeps = dyn.host_reads, dyn.substeps_run
        if variant == "sort croupier":
            k4 = _k4_on_sort_croupier_step(p, k4_launches, k4_rows, gpu)
        prof = _profile_steps(
            p, PROFILED_STEPS, "straub_" + variant.replace(" ", "_")
        )
        ms, kernels, busy = (
            prof["ms_per_step"], prof["kernels_per_step"], prof["busy_share"]
        )
        records[variant] = {
            "ms_per_step": wall / STRAUB_STEPS * 1e3,
            "host_reads_per_step": reads / STRAUB_STEPS,
            "substeps": substeps,
            "substeps_per_step": substeps / STRAUB_STEPS,
            "ms_per_step_after": ms,
            "kernels_per_step_after": kernels,
            "busy_share_after": busy,
            "substeps_per_step_after": (dyn.substeps_run - substeps)
            / (2 * PROFILED_STEPS),
        }
        outs[variant] = out
        print(f"phase 31: Straub box, {variant}, n_sd={STRAUB_N}, adaptive,"
              f" {STRAUB_STEPS} steps on the card in {wall!r} s with the"
              f" build: {records[variant]['ms_per_step']!r} ms/step,"
              f" {records[variant]['substeps_per_step']!r} substeps and"
              f" {records[variant]['host_reads_per_step']!r} host reads a"
              f" step; {PROFILED_STEPS} more steps: {ms!r} ms/step,"
              f" {records[variant]['substeps_per_step_after']!r} substeps,"
              f" {kernels!r} device kernels and busy {busy!r} a step; liquid"
              f" drift {(liquid1 - liquid0) / liquid0!r}; rates {rates} [{gpu}]")
    settings = straub_settings(model, STRAUB_N)
    t0 = time.perf_counter()
    cpu = model.run_box_breakup(
        settings, steps=[0, STRAUB_STEPS // 2, STRAUB_STEPS],
        backend_class=CPU, return_nv=True,
    )
    cpu_wall = time.perf_counter() - t0
    dlnr = np.diff(np.log(settings.radius_bins_edges))
    card = outs["closed form"]
    number = [o.y2.sum(axis=1) for o in (card, cpu)]
    liquid = [(o.y * dlnr).sum(axis=1) for o in (card, cpu)]
    rel = np.abs(number[0] / number[1] - 1)
    if not ((rel[1:] < STRAUB_NUMBER_RTOL).all()
            and np.allclose(liquid[0], liquid[1], rtol=1e-5)):
        raise AssertionError(
            f"phase 31: card against CPU float64: number {number}, liquid"
            f" {liquid}"
        )
    print(f"phase 31: the card's closed-form run against a float64 CPU run"
          f" ({cpu_wall!r} s) at seed 44: number at 0, 50, 100 s"
          f" {number[0].tolist()} against {number[1].tolist()} m^-3"
          f" (relative difference {rel.tolist()}, bound"
          f" {STRAUB_NUMBER_RTOL}), liquid under dv/dlnr {liquid[0].tolist()}"
          f" against {liquid[1].tolist()} kg/m^3 [{gpu}]")
    return records, k4


def _bieli_on_card(gpu):
    """phase 32: ``bieli_et_al_2022.run`` at its own 2^12 super-droplets
    and 60 steps on the card for each of its three Ec (0.8, 0.9, 1.0),
    Feingold 1988 fragments on the float64 breakup path: M1 conserved to
    1e-6 and, at Ec = 1, M0 falls (the JAX test's bounds); each run's M0
    and M2 at the end against a float64 CPU run at the same seed within
    ``BIELI_MOMENT_RTOL`` (statistically: the two draw other random
    numbers); ms/step, host reads and device kernels a step.
    Returns {Ec: record}"""
    import numpy as np

    from pysdm_tpu_torch.backends import CPU
    from pysdm_tpu_torch.models import bieli_et_al_2022 as model

    records = {}
    for coal_eff_index in range(3):
        settings = model.Settings()
        coal_eff = settings.coal_effs[coal_eff_index]
        with _capturing_builder(model) as built:
            t0 = time.perf_counter()
            out = model.run(settings, coal_eff=coal_eff)
            wall = time.perf_counter() - t0
        p = built[0][0]
        cpu = model.run(model.Settings(), coal_eff=coal_eff, backend_class=CPU)
        moments = {k: np.asarray(v) for k, v in out.items()}
        rates = _rates_ok(p, "phase 32")
        rel = {k: abs(moments[k][-1] / cpu[k][-1] - 1) for k in ("M0", "M2")}
        checks = {
            "on the card": p.device.type == "cuda",
            "route": p.dynamics["Collision"].route() == "float64",
            "M1": np.abs(moments["M1"] / moments["M1"][0] - 1).max() < 1e-6,
            "M0 falls": coal_eff.Ec < 1 or moments["M0"][-1] < moments["M0"][0],
            "finite": all(np.isfinite(v).all() for v in moments.values()),
            "against the CPU": all(
                rel[k] < BIELI_MOMENT_RTOL[k] for k in rel
            ),
            # Ec = 1 coalesces every collision
            "breakups": coal_eff.Ec == 1 or rates["breakup_rate"] > 0,
        }
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(
                f"phase 32: Ec={coal_eff.Ec}: {failed}: {moments}, CPU"
                f" {cpu}, rates {rates}"
            )
        prof = _profile_steps(p, PROFILED_STEPS, f"bieli_{coal_eff.Ec}")
        ms, kernels, busy = (
            prof["ms_per_step"], prof["kernels_per_step"], prof["busy_share"]
        )
        steps = settings.output_steps[-1]
        records[coal_eff.Ec] = {
            "ms_per_step": wall / steps * 1e3,
            "host_reads_per_step": p.dynamics["Collision"].host_reads / steps,
            "ms_per_step_after": ms,
            "kernels_per_step_after": kernels,
            "busy_share_after": busy,
        }
        print(f"phase 32: bieli_et_al_2022.run, Ec = {coal_eff.Ec},"
              f" n_sd={settings.n_sd}, {steps} steps (three moments read"
              f" each) on the card in {wall!r} s with the build:"
              f" {records[coal_eff.Ec]['ms_per_step']!r} ms/step, host reads"
              f" {records[coal_eff.Ec]['host_reads_per_step']!r}/step;"
              f" {PROFILED_STEPS} more steps without reads: {ms!r} ms/step,"
              f" {kernels!r} device kernels and busy {busy!r} a step; M0, M1, M2 at the end"
              f" {[float(moments[k][-1]) for k in ('M0', 'M1', 'M2')]}, float64"
              f" CPU {[float(cpu[k][-1]) for k in ('M0', 'M1', 'M2')]}"
              f" (relative differences {rel}); rates {rates} [{gpu}]")
    return records


def _pure_breakup_handle_all(gpu, steps=10):
    """phase 33: ``tests/smoke/test_box_breakup.py``'s pure-breakup box
    (``_pure_breakup_box``) with ``handle_all_breakups`` on the card, step
    by step: the loop's iterations, host reads and ms of each step; the
    water mass to 1e-6, the multiplicity grown, breakups. Then the same
    box again with the loop reading after every iteration
    (``ops/breakup.py`` ``_MAX_UNCHECKED = 1``, as the JAX package's
    ``while_loop``): the same multiplicities, and its ms a step beside.
    Returns the per-step records"""
    import numpy as np

    from pysdm_tpu_torch.ops import breakup

    records = {}
    for label, cap in (("default", breakup._MAX_UNCHECKED), ("every", 1)):
        with _replaced(breakup, "_MAX_UNCHECKED", cap):
            p, records[label] = _pure_breakup_box(gpu, steps, label)
        records[label]["multiplicity"] = p.attributes["multiplicity"]
    if not np.array_equal(records["default"].pop("multiplicity"),
                          records["every"].pop("multiplicity")):
        raise AssertionError("phase 33: the read interval changed the state")
    return records


def _pure_breakup_box(gpu, steps, label):
    """the box of phase 33 (2^10 super-droplets of 1e8 drops, 20 um +- a
    factor 2 in volume, ConstantK 1e-9 m^3/s, ``AlwaysN(n=4)``, dt = 1 s,
    one substep, seed 44) run ``steps`` steps one by one on the card.
    Returns (the particulator, the per-step record)"""
    import numpy as np

    from pysdm_tpu_torch import Builder, Formulae
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.dynamics import Breakup
    from pysdm_tpu_torch.dynamics.collisions.breakup_fragmentations import AlwaysN
    from pysdm_tpu_torch.dynamics.collisions.collision_kernels import ConstantK
    from pysdm_tpu_torch.environments import Box

    n_sd = 2**10
    rng = np.random.default_rng(44)
    builder = Builder(
        n_sd=n_sd, backend=GPU(Formulae(seed=44, handle_all_breakups=True)),
        environment=Box(dt=1.0, dv=1.0),
    )
    dyn = Breakup(
        collision_kernel=ConstantK(a=1e-9), fragmentation_function=AlwaysN(n=4),
        adaptive=False, substeps=1,
    )
    builder.add_dynamic(dyn)
    p = builder.build({
        "multiplicity": np.full(n_sd, 1e8),
        "volume": rng.uniform(0.5, 2.0, n_sd) * (20e-6) ** 3,
    }, products=())
    mult0, mass0 = _totals(p)[1], _totals(p)[0]
    record = {"iterations": [], "host_reads": [], "ms": []}
    for _ in range(steps):
        it0, reads0 = dyn.breakup_iterations, dyn.host_reads
        t0 = time.perf_counter()
        p.run(1)
        p.block_until_ready()
        record["ms"].append((time.perf_counter() - t0) * 1e3)
        record["iterations"].append(dyn.breakup_iterations - it0)
        record["host_reads"].append(dyn.host_reads - reads0)
    mult1, mass1 = _totals(p)[1], _totals(p)[0]
    rates = _rates_ok(p, "phase 33")
    if not (p.device.type == "cuda" and dyn.route() == "float64"
            and abs(mass1 - mass0) <= 1e-6 * mass0 and mult1 > mult0
            and rates["breakup_rate"] > 0):
        raise AssertionError(
            f"phase 33: mass {mass0} -> {mass1}, multiplicity {mult0} ->"
            f" {mult1}, rates {rates}, {record}"
        )
    print(f"phase 33: pure breakup with handle_all_breakups, n_sd={n_sd},"
          f" reads {label}, {steps} steps on the card: loop iterations"
          f" {record['iterations']},"
          f" host reads {record['host_reads']}, ms {record['ms']}; water"
          f" mass drift {(mass1 - mass0) / mass0!r}, multiplicity {mult0!r}"
          f" -> {mult1!r} [{gpu}]")
    return p, record


# float32 operations charged to one minfun evaluation under each film form
# of the surface tension, on top of K3_OPS_PER_MINFUN (counted from
# csrc/condensation.cu film_sigma, each transcendental call one operation):
# Ovadnevaite's volume, cbrt, cube, quotient and mean (14); Szyszkowski-
# Langmuir's isotherm, quadratic root and log1p (29); Ruehl's isotherm and
# 64 + 1 evaluations of its residual (17 each) with the halving
K3_FILM_OPS_PER_MINFUN = {
    "Constant": 0,
    "CompressedFilmOvadnevaite": 14,
    "SzyszkowskiLangmuir": 29,
    "CompressedFilmRuehl": 8 + 65 * 17,
}
K3_VARIANT_NS = (N_PARCEL, N_MAIN)
K3_PARENT_DIR = "build/k3_parent"
# the build before the variant sets (commit 84c2b8f), whose ABI
# ``_parent_k3`` mirrors: its condensation.cu is taken by git's blob id, so
# that a later commit's file is never called through this ABI
K3_PARENT_COMMIT = "84c2b8f"
K3_PARENT_BLOB = "e41cc731a30a900ac07136ac6643d25b53ea7a9e"


def k3_variant_bound(formulae, rows, evaluations):
    """(ms, what sets it) for K3 on ``rows``: 29 bytes a drop, 4 more for
    each optional row read; the operations of the minfun evaluations"""
    n = rows["water_mass"].shape[0]
    n_bytes = n * (29 + 4 * sum(k in rows for k in K3_OPTIONAL))
    ops = K3_OPS_PER_MINFUN + K3_FILM_OPS_PER_MINFUN[
        formulae.surface_tension.variant
    ]
    return bound_ms(n_bytes, evaluations * ops)


def k3_near_saturation_rows(formulae, rows, RH=1.0002, cell=0):
    """``rows`` with the vapour of ``cell`` set so that its RH (float64)
    is ``RH``: the regime of ``compare_k3_near_saturation``"""
    import torch

    from pysdm_tpu_torch.ops.condensation import thermo

    near = dict(rows)
    cells = [torch.from_numpy(rows[k]).double() for k in (
        "thd", "qv", "rhod", "rho_air", "mu_air",
    )]
    qv = rows["qv"].astype("float64")
    for _ in range(3):  # RH goes with qv to within its pressure's weight
        cells[1] = torch.from_numpy(qv)
        rh = thermo(formulae, *cells)[2].numpy()
        qv[cell] *= RH / rh[cell]
    near["qv"] = qv.astype(rows["qv"].dtype)
    return near


def _k3_set_near_saturation(torch, k3, formulae, settings, rows, device):
    """K3 against its twin on ``rows`` with their growing cell brought to
    RH = 1.0002 (``k3_near_saturation_rows``), by
    ``compare_k3_near_saturation``; returns what it saw"""
    near = k3_near_saturation_rows(formulae, rows)
    args = [torch.from_numpy(near[k]).to(device) for k in K3_ARGS]
    extra = k3_optional(torch, near, device)

    def twin_of(rs):
        return k3.masses_new_reference(
            formulae, settings, *rs,
            **{k: v.to(rs[0].dtype) for k, v in extra.items()},
        )

    kernel = k3.masses_new(formulae, settings, *args, **extra)
    return compare_k3_near_saturation(formulae, settings, args, kernel, twin_of)


def _git_blob_id(data):
    import hashlib

    return hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()


def _parent_k3(torch):
    """the parent build's K3 (the ``condensation.cu`` of
    ``K3_PARENT_COMMIT``, from ``K3_PARENT_DIR`` where the file there is
    that blob, else from git, built with the source's flags into
    ``build/``) as a function of (params, args), or None where neither has
    it"""
    import ctypes
    import os

    from pysdm_tpu_torch.ops.cuda import _build

    src = os.path.join(K3_PARENT_DIR, "condensation.cu")
    data = b""
    if os.path.exists(src):
        with open(src, "rb") as f:
            data = f.read()
    if _git_blob_id(data) != K3_PARENT_BLOB:
        found = subprocess.run(
            ["git", "show",
             f"{K3_PARENT_COMMIT}:pysdm_tpu_torch/csrc/condensation.cu"],
            capture_output=True,
        )
        if found.returncode != 0 or _git_blob_id(found.stdout) != K3_PARENT_BLOB:
            return None
        os.makedirs(K3_PARENT_DIR, exist_ok=True)
        with open(src, "wb") as out:
            out.write(found.stdout)
    lib_path = os.path.join(K3_PARENT_DIR, "libcondensation_parent.so")
    subprocess.run(
        [_build.nvcc_path(), *_build.flags("condensation"), "-o", lib_path,
         src], check=True, capture_output=True,
    )
    lib = ctypes.CDLL(os.path.abspath(lib_path))

    class ParentParams(ctypes.Structure):
        _fields_ = [
            *((name, ctypes.c_float) for name in (
                "T0", "p1000", "Rd", "Rv", "eps", "T_exponent", "l_tri",
                "c_pv_minus_c_pw", "T_tri",
            )),
            ("fwc", ctypes.c_float * 9),
            *((name, ctypes.c_float) for name in (
                "D0", "K0", "rho_w", "pi_4_3", "one_third", "koehler_A",
                "lambdaK_coef", "two_Rd", "two_Rv", "mac_a", "mac_b",
                "hac_a", "hac_b", "rho_w_Rv", "four_pi_rho_w", "x_max",
                "RH_rtol", "rtol_x", "per_mass",
            )),
            *((name, ctypes.c_int) for name in (
                "max_iters", "bisect_cap", "coordinate", "hygroscopicity",
                "drop_growth", "kinetics",
            )),
        ]

    def call(params, args):
        old = ParentParams(**{
            name: getattr(params, name) for name, _ in ParentParams._fields_
            if name != "fwc"
        })
        old.fwc = (ctypes.c_float * 9)(*list(params.svp)[:9])
        mass = torch.empty_like(args[0])
        success = torch.empty(args[0].shape, dtype=torch.bool,
                              device=args[0].device)
        err = lib.pysdm_condensation_masses_new(
            *(ctypes.c_void_p(t.data_ptr()) for t in args),
            ctypes.c_int(args[0].shape[0]), ctypes.c_int(args[5].shape[0]),
            ctypes.byref(old), ctypes.c_void_p(mass.data_ptr()),
            ctypes.c_void_p(success.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
        if err != 0:
            raise RuntimeError(f"the parent's K3 failed to launch ({err})")
        return mass, success

    return call


def _k3_variant_sets(torch, k3, device, gpu):
    """phase 34: K3 against its twin on the card for each set of
    ``K3_VARIANT_SETS`` at 2^17 and 2^20 drops (``k3_variant_rows``, haze
    settled by the kernel): the regimes, success equal and the log-mass
    bound of ``compare_k3``, the drops shuffled bit-equal to the sorted run,
    the minfun evaluations (counted by the twin), the kernel's device time
    (and the twin's at 2^17) and the bound; then the parcel slice's set
    against the parent build's kernel, bit-equal, timed in turns. Returns
    {set: record}"""
    from pysdm_tpu_torch.ops.condensation import DropSolveSettings

    settings = DropSolveSettings(*K3_SETTINGS)
    records = {}
    for name in K3_VARIANT_SETS:
        formulae = k3_variant_formulae(name)
        record = {"max_abs_err": 0.0}
        for n in K3_VARIANT_NS:
            rows = settle_haze(
                formulae, k3_variant_rows(name, n, seed=n), device
            )
            args = [torch.from_numpy(rows[k]).to(device) for k in K3_ARGS]
            extra = k3_optional(torch, rows, device)
            before = k3.masses_new.launches
            kernel = k3_call(k3.masses_new, formulae, settings, rows, device)
            if k3.masses_new.launches != before + 1:
                raise AssertionError("K3's counter did not count the launch")
            stats = {}
            twin = k3.masses_new_reference(
                formulae, settings, *args, stats=stats, **extra
            )
            twin = twin[0].cpu().numpy(), twin[1].cpu().numpy()
            check_k3_regimes(rows, *kernel)
            check_k3_regimes(rows, *twin)
            abs_err, rel_err = compare_k3(rows, kernel, twin, settings.rtol_x)
            record["max_abs_err"] = max(record["max_abs_err"], abs_err)
            permuted, order = k3_permuted_rows(rows)
            shuffled = k3_call(k3.masses_new, formulae, settings, permuted,
                               device)
            for got, want in zip(shuffled, kernel):
                if (got != want[order]).any():
                    raise AssertionError(
                        f"phase 34: {name}: a drop's result depends on its block"
                    )
            ms = _time_ms(
                torch, lambda: k3.masses_new(formulae, settings, *args, **extra),
                20,
            )
            evaluations = stats["minfun_evaluations"]
            bound = k3_variant_bound(formulae, rows, evaluations)
            twin_ms = None
            if n == N_PARCEL:
                twin_ms = _time_ms(
                    torch,
                    lambda: k3.masses_new_reference(
                        formulae, settings, *args, **extra
                    ),
                    2,
                )
                record.update(ms=ms, twin_ms=twin_ms, bound_ms=bound[0],
                              bound_by=bound[1], evaluations=evaluations)
            else:
                record.update(ms_2_20=ms, bound_ms_2_20=bound[0],
                              evaluations_2_20=evaluations)
            if n == N_PARCEL:
                record["near_saturation"] = _k3_set_near_saturation(
                    torch, k3, formulae, settings, rows, device
                )
            print(f"phase 34: K3 set {name} n={n}: success equal, mass max"
                  f" abs diff {abs_err!r} kg, max rel diff {rel_err!r}, the"
                  f" drops shuffled bit-equal; kernel {ms!r} ms"
                  + (f", twin {twin_ms!r} ms" if twin_ms is not None else "")
                  + f"; {evaluations} minfun evaluations"
                  f" ({evaluations / n!r} per drop), bound {bound[0]!r} ms"
                  f" ({bound[1]})"
                  + (f"; near saturation {record['near_saturation']}"
                     if n == N_PARCEL else "")
                  + f" [{gpu}]")
        records[name] = record
    parent = _parent_k3(torch)
    if parent is None:
        print(f"phase 34: the condensation.cu of {K3_PARENT_COMMIT} is not"
              f" at hand ({K3_PARENT_DIR}, git): no comparison with it")
        return records
    from pysdm_tpu_torch import Formulae

    formulae = Formulae(seed=44)
    params = k3.kernel_params(formulae, settings)
    for n in K3_VARIANT_NS:
        rows = settle_haze(formulae, k3_rows(n, seed=n), device)
        args = [torch.from_numpy(rows[k]).to(device).contiguous()
                for k in K3_ARGS]
        new = k3.masses_new(formulae, settings, *args)
        old = parent(params, args)
        for got, want in zip(new, old):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"phase 34: the parcel set at n={n} is not bit-equal to"
                    " the parent build's kernel"
                )
        times = {"new": [], "parent": []}
        for _ in range(3):
            times["new"].append(_time_ms(
                torch, lambda: k3.masses_new(formulae, settings, *args), 20
            ))
            times["parent"].append(_time_ms(
                torch, lambda: parent(params, args), 20
            ))
        records.setdefault("parcel_vs_parent", {})[n] = times
        print(f"phase 34: the parcel slice's set at n={n}: bit-equal to the"
              f" parent build's kernel; kernel {times['new']!r} ms, parent"
              f" {times['parent']!r} ms (in turns) [{gpu}]")
    return records


def _model_window(p, run, steps):
    """run ``run()`` (``steps`` steps of ``p``) with K3's and K1's counts
    set to 0 just before and read just after; returns a record of the
    window: ms/step, launches, solves, collision substeps, and the reads
    that the condensation solver and the collision loop make. The model's
    own reads of attributes and products (``run``'s output) are not
    counted"""
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3

    solver = p.dynamics["Condensation"].solver
    collision = p.dynamics.get("Collision")
    solves0, reads0 = solver.substep_solves, solver.host_reads
    substeps0 = (int(p.get_counter("collision_n_substep").sum())
                 if collision else 0)
    collision_reads0 = collision.host_reads if collision else 0
    k3.masses_new.launches = 0
    kern.coalesce_mirror.launches = 0
    t0 = time.perf_counter()
    out = run()
    p.block_until_ready()
    wall = time.perf_counter() - t0
    record = {
        "k3_launches": k3.masses_new.launches,
        "k1_launches": kern.coalesce_mirror.launches,
        "solves": solver.substep_solves - solves0,
        "ms_per_step": wall / steps * 1e3,
        "solver_and_collision_reads_per_step": (
            (solver.host_reads - reads0) / steps
        ),
    }
    if collision:
        record["collision_substeps"] = (
            int(p.get_counter("collision_n_substep").sum()) - substeps0
        )
        record["solver_and_collision_reads_per_step"] += (
            collision.host_reads - collision_reads0
        ) / steps
    if p.device.type == "cuda" and record["k3_launches"] != record["solves"]:
        raise AssertionError(f"K3 launches != solves: {record}")
    if collision and p.device.type == "cuda" and (
        record["k1_launches"] != record["collision_substeps"]
    ):
        raise AssertionError(f"K1 launches != collision substeps: {record}")
    return out, record


@contextlib.contextmanager
def _keeping_calls(module, name, keep, limit=None):
    """``module.name``, a kernel's wrapper, replaced inside the block by one
    that passes every call on and keeps a clone of the arguments
    (positional, keyword; the tensors of a dict argument cloned too) of
    each call whose index ``keep`` selects, at most ``limit`` of them;
    yields the list of kept ``(args, kwargs)``. The
    replacement's ``launches`` starts at 0: a wrapper that counts through
    its module's name (K3's) counts there inside the block"""
    import torch

    real, kept, calls = getattr(module, name), [], [0]

    def clone(v):
        if isinstance(v, dict):
            return {k: clone(x) for k, x in v.items()}
        return v.clone() if torch.is_tensor(v) else v

    def cloned(values):
        return [clone(v) for v in values]

    def keeping(*args, **kwargs):
        if (limit is None or len(kept) < limit) and keep(calls[0]):
            kept.append((cloned(args), dict(zip(kwargs, cloned(kwargs.values())))))
        calls[0] += 1
        return real(*args, **kwargs)

    keeping.launches = 0
    with _replaced(module, name, keeping):
        yield kept


def k3_on_kept_solve(kept, label):
    """K3 on a kept solve's inputs (``_keeping_calls``) against its twin on
    the same device: ``compare_k3_near_saturation``'s bounds, and on the
    graves (multiplicity 0) the twin's results exactly. Returns what
    ``compare_k3_near_saturation`` saw, with the drop and grave counts"""
    import torch

    from pysdm_tpu_torch.ops.cuda import condensation as k3

    (formulae, settings, *rows), optional = kept

    def twin_of(rows):
        return k3.masses_new_reference(formulae, settings, *rows, **optional)

    kernel = k3.masses_new(formulae, settings, *rows, **optional)
    graves = rows[3] == 0
    twin = twin_of(rows)
    for got, want in zip(kernel, twin):
        if not torch.equal(got[graves], want[graves]):
            raise AssertionError(f"{label}: K3 on the graves differs from the twin")
    seen = compare_k3_near_saturation(formulae, settings, rows, kernel, twin_of)
    return {**seen, "drops": rows[0].shape[0], "graves": int(graves.sum())}


def k1_on_kept_substep(args, label):
    """K1 on a kept substep's inputs against its twin on the same device, at
    phase 20's bounds (xi equal, the extensive rows to rtol 1e-6, the rates
    to 1e-5); then with the substep's probability scale times 2^10, so that
    pairs merge (xi equal, the rows to 1e-6). Returns {case: (slots
    changed, the rows' max abs err)}"""
    import numpy as np

    from pysdm_tpu_torch.ops.cuda import collision as kern

    mult = args[0].cpu().numpy()
    seen = {}
    for case, factor in (("as drawn", 1.0), ("probabilities x 2^10", 2.0**10)):
        call = [*args[:5], args[5] * factor, *args[6:]]
        got = [x.cpu().numpy() for x in kern.coalesce_mirror(*call)]
        want = [x.cpu().numpy() for x in kern.coalesce_mirror_reference(*call)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
        if factor == 1.0:
            for g, w in zip(got[2:], want[2:]):
                np.testing.assert_allclose(g, w, rtol=1e-5)
        seen[case] = (
            int((got[0] != mult).sum()),
            float(np.abs(got[1].astype(np.float64) - want[1]).max()),
        )
    if seen["probabilities x 2^10"][0] == 0:
        raise AssertionError(f"{label}: K1 merged no pair: {seen}")
    return seen


LOWE_FULL_PER_MODE = 2**16
LOWE_CPU_PER_MODE = 2**11


def _lowe(gpu):
    """phase 35: ``lowe_et_al_2019.Simulation`` on the card: the JAX test
    (``AerosolMarine(Forg=0.2)``, 16 super-droplets per mode, dz = 5 m, the
    200 m ascent) with ``Constant`` and ``CompressedFilmOvadnevaite``, CDNC
    higher with the film; then the film at 2^16 per mode (2^17 drops) over
    every step of the ascent, K3 launches = solves, against a float64 CPU
    run of the port at 2^11 per mode (S_max and CDNC). Returns {model:
    record}"""
    import numpy as np

    from pysdm_tpu_torch.backends import CPU, GPU
    from pysdm_tpu_torch.models import lowe_et_al_2019 as model

    wmv = 18.015e-3 / 1000.0
    cdnc, records = {}, {}
    for st in ("Constant", "CompressedFilmOvadnevaite"):
        settings = model.Settings(
            dz=5.0, n_sd_per_mode=16,
            aerosol=model.AerosolMarine(water_molar_volume=wmv, Forg=0.2),
            model=st,
        )
        sim = model.Simulation(settings)
        out, record = _model_window(sim.particulator, sim.run, settings.nt)
        cdnc[st] = out["CDNC"][-1]
        records[st] = record
    if not cdnc["CompressedFilmOvadnevaite"] > cdnc["Constant"]:
        raise AssertionError(f"phase 35: CDNC with the film not higher: {cdnc}")
    print(f"phase 35: Lowe et al. 2019, AerosolMarine(Forg=0.2), 32"
          f" super-droplets, 40 steps on the card: CDNC {cdnc['Constant']!r}"
          f" (Constant) < {cdnc['CompressedFilmOvadnevaite']!r} (film);"
          f" {records} [{gpu}]")
    full = {}
    for per_mode, backend in ((LOWE_FULL_PER_MODE, GPU),
                              (LOWE_CPU_PER_MODE, CPU)):
        settings = model.Settings(
            dz=5.0, n_sd_per_mode=per_mode,
            aerosol=model.AerosolMarine(water_molar_volume=wmv, Forg=0.2),
            model="CompressedFilmOvadnevaite",
        )
        sim = model.Simulation(settings, backend_class=backend)
        out, record = _model_window(sim.particulator, sim.run, settings.nt)
        record.update(S_max=float(np.nanmax(out["S_max"])),
                      CDNC=out["CDNC"][-1])
        if not (np.isfinite(out["CDNC"]).all()
                and sim.particulator.get_counter("condensation_success").all()):
            raise AssertionError(f"phase 35: {out}")
        full["card" if backend is GPU else "cpu_float64"] = record
    card, ref = full["card"], full["cpu_float64"]
    if not (abs(card["S_max"] - ref["S_max"]) < 0.1 * ref["S_max"]
            and abs(card["CDNC"] / ref["CDNC"] - 1) < 0.05):
        raise AssertionError(f"phase 35: card {card} against float64 {ref}")
    bound = bound_ms(
        2 * LOWE_FULL_PER_MODE * 37 * card["solves"] / 40,
    )
    print(f"phase 35: Lowe et al. 2019 with the film at"
          f" {2 * LOWE_FULL_PER_MODE} super-droplets, 40 steps on the card:"
          f" {card['ms_per_step']!r} ms/step, {card['k3_launches']} K3"
          f" launches = solves,"
          f" {card['solver_and_collision_reads_per_step']!r} solver"
          f" reads/step, S_max {card['S_max']!r}, CDNC {card['CDNC']!r}; the"
          f" float64 CPU run at {2 * LOWE_CPU_PER_MODE}: S_max"
          f" {ref['S_max']!r}, CDNC {ref['CDNC']!r}; K3's bytes a step bound"
          f" {bound[0]!r} ms [{gpu}]")
    records["film_full_width"] = card
    records["film_cpu_float64"] = ref
    return records


JN_FULL_N = 2**17


def _jensen_nugent(gpu):
    """phase 36: ``jensen_and_nugent_2017.Simulation`` on the card (Sc,
    pristine, GCCN): the JAX test (24 super-droplets beside the GCCN, 600
    steps of 2 s) at its bounds, then 2^17 beside the GCCN with
    gravitational coalescence (``Geometric``, K1 on the mirror croupier),
    600 steps: K3 launches = solves, K1 launches = collision substeps"""
    import numpy as np

    from pysdm_tpu_torch.models import jensen_and_nugent_2017 as model

    records = {}
    for n_sd, coalescence in ((24, False), (JN_FULL_N, True)):
        settings = model.Settings(aerosol="pristine", cloud_type="Sc", dt=2.0)
        sim = model.Simulation(
            settings, gccn=True, n_sd_non_gccn=n_sd,
            gravitational_coalescence=coalescence,
        )
        p = sim.particulator
        out, record = _model_window(
            p, lambda: sim.run(n_steps=600, steps_per_output_interval=100), 600
        )
        s_max = np.nanmax(out["products"]["S_max"])
        checks = {
            "0 < S_max < 0.05": 0.0 < s_max < 0.05,
            "r_act above 1 um": np.nanmax(out["products"]["r_mean_act"]) > 1e-6,
            "GCCN above 10 um": out["attributes"]["radius"][-1].max() > 10e-6,
            "z rises": out["products"]["z"][-1] > out["products"]["z"][0],
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"phase 36: n_sd={n_sd}: {failed}")
        record["S_max"] = float(s_max)
        records[n_sd] = record
        print(f"phase 36: Jensen & Nugent 2017 (Sc, pristine, GCCN),"
              f" {n_sd} super-droplets + GCCN, coalescence {coalescence},"
              f" 600 steps on the card: {record} [{gpu}]")
    return records


YANG_FULL_N = 2**17
# dry air of the Yang parcel at YANG_FULL_N: at the model's 1000 kg the
# spectrum's tail takes multiplicities below 1 at 2^17 super-droplets
YANG_FULL_MASS_OF_DRY_AIR = 1e6


def yang_settings(n_sd):
    """``yang_et_al_2018.Settings`` of the JAX test (2400 s, dt_max 5 s, 480
    steps); above 2^12 super-droplets in a parcel of
    ``YANG_FULL_MASS_OF_DRY_AIR``, its spectrum sampled anew (the same
    concentrations per kilogram of air)"""
    from pysdm_tpu_torch.initialisation import spectra
    from pysdm_tpu_torch.initialisation.sampling import spectral_sampling
    from pysdm_tpu_torch.models import yang_et_al_2018 as yang
    from pysdm_tpu_torch.physics import si

    settings = yang.Settings(n_sd=n_sd, total_time=2400.0, dt_max=5.0)
    settings.n_steps = int(settings.total_time / 5.0)
    if n_sd > 2**12:
        settings.mass_of_dry_air = YANG_FULL_MASS_OF_DRY_AIR
        settings.r_dry, settings.n = spectral_sampling.Logarithmic(
            spectrum=spectra.Lognormal(
                norm_factor=1000 / si.mg * settings.mass_of_dry_air,
                m_mode=50 * si.nm, s_geom=1.4,
            ),
            size_range=(10.633 * si.nm, 513.06 * si.nm),
        ).sample(n_sd)
    return settings


def _yang_and_arabas_shima(gpu):
    """phase 37: ``yang_et_al_2018.Simulation`` on the card at the JAX
    test's bounds with 32 super-droplets (2400 s, dt_max 5 s), then at 2^17
    over the same 2400 s; ``arabas_and_shima_2017.Simulation`` at the JAX
    test's settings, one super-droplet"""
    import numpy as np

    from pysdm_tpu_torch.models import arabas_and_shima_2017 as arabas_shima
    from pysdm_tpu_torch.models import yang_et_al_2018 as yang
    from pysdm_tpu_torch.physics import si

    records = {}
    for n_sd in (32, YANG_FULL_N):
        settings = yang_settings(n_sd)
        sim = yang.Simulation(settings)
        out, record = _model_window(
            sim.particulator, sim.run, settings.n_steps * sim.n_substeps
        )
        S, z = np.asarray(out["S"]), np.asarray(out["z"])
        i_t0 = np.searchsorted(np.asarray(out["t"]), 1200.0)
        checks = {
            "S above 0": S.max() > 0.0,
            "S falls after t0": S[i_t0:].min() < S.max(),
            "z above 1100 m": z.max() > 1100.0,
            "z descends": z[-1] < z.max(),
            "r_act above 1 um": np.nanmax(np.asarray(out["r_act"])) > 1e-6,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"phase 37: Yang n_sd={n_sd}: {failed}")
        records[f"yang_{n_sd}"] = record
        print(f"phase 37: Yang et al. 2018, {n_sd} super-droplets, 2400 s:"
              f" {record}, S max {S.max()!r} [{gpu}]")
    settings = arabas_shima.Settings(
        w_avg=1.0, N_STP=50 / si.cm**3, r_dry=0.1 * si.um,
        mass_of_dry_air=1e3 * si.kg, n_output=100,
    )
    sim = arabas_shima.Simulation(settings)
    out, record = _model_window(sim.particulator, sim.run, settings.n_output)
    rh, r = np.asarray(out["RH"]), np.asarray(out["r"])
    if not (rh.max() > 1.0 and r.max() > 1e-6 and rh[-1] < rh.max()):
        raise AssertionError(f"phase 37: Arabas & Shima: {out}")
    records["arabas_shima"] = record
    print(f"phase 37: Arabas & Shima 2017, one super-droplet, 100 steps:"
          f" {record}, RH max {rh.max()!r}, r max {r.max()!r} [{gpu}]")
    return records



# --- phases 38-42: the models that need only what is ported ----------------
MG_GRID = (25, 25)
MG_SD_PER_CELL = 2**12
MG_STEPS = 30
MG_PROFILED_STEPS = 3
# Bigg's median freezing-temperature depression (K): the constant is NaN by
# default, and so are the freezing temperatures the JAX test samples
MG_BIGG_DT_MEDIAN = 33.0
MG_TEST_GRID = (6, 6)
MG_TEST_SD_PER_CELL = 8


def mg2007_mixed_phase(backend, grid, n_sd_per_gridbox, rhod_w_max=0.6,
                       size=(1500.0, 1500.0), bigg=MG_BIGG_DT_MEDIAN):
    """the Morrison & Grabowski 2007 strato-cumulus with singular immersion
    freezing on the mixed-phase grid (``Bigg_1953``, ``MixedPhaseSpheres``,
    dt 5 s, from the haze start) through the port's ``make_simulation``;
    ``backend`` None takes its default (the card), ``bigg`` None the
    constant's default (NaN). Returns (particulator, spin_up)"""
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.models import morrison_and_grabowski_2007 as model

    settings = model.StratoCumulus(
        Formulae(
            seed=44, freezing_temperature_spectrum="Bigg_1953",
            particle_shape_and_density="MixedPhaseSpheres",
            constants=None if bigg is None else {"BIGG_DT_MEDIAN": bigg},
        ),
        rhod_w_max=rhod_w_max, grid=grid, size=size, dt=5.0,
        n_sd_per_gridbox=n_sd_per_gridbox, spin_up_time=0,
    )
    settings.processes["freezing"] = True
    kwargs = {} if backend is None else {"backend_class": backend}
    return model.make_simulation(settings, **kwargs)


def _sorted_rows(p, names):
    """the rows ``names`` of every slot, as a (n_sd, len(names)) array in
    lexicographic order (a multiset that no permutation changes)"""
    import numpy as np

    rows = np.stack([p.attributes[name] for name in names], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _gamma_rates_vs_float64(p, compute_gamma, prob, rand, mult, pairing,
                            cell_start, n_cell):
    """``compute_gamma`` on a captured substep's inputs, into zeroed
    counters: its per-cell collision rates (float32 products summed by K4
    as prefix differences) against the float64 per-cell sums of gamma x
    xi_k on the host, within 1e-5 of the float64 prefix (phase 8's K4
    bound). Returns {cells with collisions, max abs err, the prefix}"""
    import numpy as np
    import torch

    counters = {k: torch.zeros_like(v) for k, v in p.sim_state["counters"].items()}
    gamma = compute_gamma(prob, rand, mult, pairing, counters, cell_start, n_cell)
    mk = torch.minimum(mult, pairing.partner(mult))
    rate = torch.where(pairing.is_first, gamma.double() * mk.double(), 0.0)
    prefix = np.concatenate([[0.0], np.cumsum(rate.cpu().numpy())])
    starts = cell_start.cpu().numpy()
    want = prefix[starts[1:n_cell + 1]] - prefix[starts[:n_cell]]
    got = counters["collision_rate"].double().cpu().numpy()
    err = float(np.abs(got - want).max())
    if not ((want > 0).any() and err <= 1e-5 * prefix[-1]):
        raise AssertionError(
            f"per-cell collision rates: max abs err {err} of {prefix[-1]},"
            f" {(want > 0).sum()} cells with collisions"
        )
    return {"cells_with_collisions": int((want > 0).sum()),
            "max_abs_err": err, "prefix": float(prefix[-1])}


def _mg2007_on_card(gpu):
    """phase 38: MG2007's mixed-phase grid at config #5's full width (25 x
    25 cells x 2^12) on the card, through ``make_simulation``: the
    float64 collision route with the max-merged freezing temperature, K2
    never launched, K3 launches = solves, K4 counted; the water budget, the
    freezing temperatures, the adaptive loop's reads, the shared sort
    carrying the max row, K3 and K4 on one step's inputs against their
    twins, the profiled busy share; then the JAX test's 6 x 6 x 8 case at
    its bounds. Returns the path's record"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.ops import collisions as coll_ops
    from pysdm_tpu_torch.ops import segments
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    t0 = time.perf_counter()
    p, spin_up = mg2007_mixed_phase(None, MG_GRID, MG_SD_PER_CELL)
    build_s = time.perf_counter() - t0
    collision = p.dynamics["Collision"]
    solver = p.dynamics["Condensation"].solver
    if p.device.type != "cuda" or p.n_sd != 625 * MG_SD_PER_CELL:
        raise AssertionError(f"phase 38: built {p.n_sd} on {p.device}")
    if collision.route() != "float64" or "Freezing" not in p.dynamics:
        raise AssertionError(f"phase 38: route {collision.route()}")
    t_fz0 = np.unique(p.attributes["freezing temperature"])
    if not np.isfinite(t_fz0).all():
        raise AssertionError("phase 38: freezing temperatures not finite")
    spin_up.finish()
    p.run(1)
    p.block_until_ready()

    water0 = _column_water(p)
    precipitated = torch.zeros((), dtype=torch.float64, device=p.device)
    substeps0, solves0 = collision.substeps_run, solver.substep_solves
    reads0, collision_reads0 = _host_reads(p), collision.host_reads
    kern.coalesce_adjacent.launches = 0
    k3.masses_new.launches = 0
    scan.cumsum.launches = 0
    scan.cumsum.rows = 0
    t0 = time.perf_counter()
    for _ in range(MG_STEPS):
        p.run(1)
        # this step's precipitation, summed on the device
        precipitated += p.sim_state["counters"]["precipitated_mass"].double().sum()
    p.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = {
        "coalesce_adjacent": kern.coalesce_adjacent.launches,
        "masses_new": k3.masses_new.launches,
        "cumsum": scan.cumsum.launches,
        "cumsum rows": scan.cumsum.rows,
    }
    substeps = collision.substeps_run - substeps0
    solves = solver.substep_solves - solves0
    collision_reads = collision.host_reads - collision_reads0
    reads = _host_reads(p) - reads0
    if launches["coalesce_adjacent"] != 0:
        raise AssertionError(f"phase 38: K2 launched on the float64 route: {launches}")
    if launches["masses_new"] != solves or launches["cumsum"] == 0:
        raise AssertionError(f"phase 38: {launches} for {solves} solves")
    # the adaptive loop reads once per substep and once to end each step
    if substeps < MG_STEPS or collision_reads != substeps + MG_STEPS:
        raise AssertionError(
            f"phase 38: {collision_reads} collision reads for {substeps}"
            f" substeps in {MG_STEPS} steps"
        )
    precipitated = float(precipitated)
    drift = (_column_water(p) + precipitated - water0) / water0
    signed = p.attributes["signed water mass"]
    mult = p.attributes["multiplicity"]
    t_fz = p.attributes["freezing temperature"]
    t_fz1 = np.unique(t_fz)
    checks = {
        "water to 1e-3": abs(drift) < 1e-3,
        "finite": np.isfinite(signed).all() and np.isfinite(t_fz).all(),
        "no ice": (signed[mult > 0] > 0).all(),
        "multiplicities >= 0": (mult >= 0).all(),
        "T_fz among the initial": np.isin(t_fz1, t_fz0).all(),
        "fewer distinct T_fz": len(t_fz1) < len(t_fz0),
        "condensation success": p.get_counter("condensation_success").all(),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 38: {failed}: drift {drift}")
    per_step = {k: v / MG_STEPS for k, v in launches.items()}
    record = {
        "n_sd": p.n_sd,
        "build_s": build_s,
        "ms_per_step": elapsed / MG_STEPS * 1e3,
        "launches_per_step": per_step,
        "collision_substeps_per_step": substeps / MG_STEPS,
        "solves_per_step": solves / MG_STEPS,
        "host_reads_per_step": reads / MG_STEPS,
        "water_drift": drift,
        "precipitated_kg": precipitated,
        "distinct_T_fz": [len(t_fz0), len(t_fz1)],
        "coalescence_rate": float(p.get_counter("coalescence_rate").sum()),
    }
    print(f"phase 38: MG2007 mixed-phase {MG_GRID} x {MG_SD_PER_CELL}"
          f" ({p.n_sd} super-droplets, built in {build_s!r} s), route"
          f" float64, {MG_STEPS} steps after one: {record['ms_per_step']!r}"
          f" ms/step; launches per step {per_step} (K2 none), collision"
          f" substeps {substeps / MG_STEPS!r}/step with one read each and"
          f" one a step, condensation solves {solves / MG_STEPS!r}/step,"
          f" host reads {reads / MG_STEPS!r}/step; water drift {drift!r}"
          f" with {precipitated!r} kg precipitated; distinct freezing"
          f" temperatures {len(t_fz0)} -> {len(t_fz1)}, each an initial one;"
          f" no ice [{gpu}]")

    # one more step: K3's first solve, every scan given to K4 and the
    # first collision substep's gamma inputs captured
    captured = {"k4": {}, "gamma": []}
    real_k4 = segments.cumsum
    real_gamma = coll_ops.compute_gamma

    def capture_gamma(prob, rand, mult_s, pairing, counters=None,
                      cell_start=None, n_cell=1):
        if not captured["gamma"]:
            captured["gamma"].append((prob.clone(), rand.clone(),
                                      mult_s.clone(), pairing,
                                      cell_start.clone(), n_cell))
        return real_gamma(prob, rand, mult_s, pairing, counters, cell_start,
                          n_cell)

    def capture_k4(x):
        captured["k4"].setdefault((x.dtype, x.dim(), x.shape[-1]), x.clone())
        return real_k4(x)

    with contextlib.ExitStack() as stack:
        k3_kept = stack.enter_context(
            _keeping_calls(k3, "masses_new", lambda _: True, limit=1)
        )
        stack.enter_context(_replaced(segments, "cumsum", capture_k4))
        stack.enter_context(_replaced(coll_ops, "compute_gamma", capture_gamma))
        p.run(1)
        p.block_until_ready()
    if not (k3_kept and captured["k4"] and captured["gamma"]):
        raise AssertionError(f"phase 38: a kernel was not called: {captured}")
    rate_err = _gamma_rates_vs_float64(p, real_gamma, *captured["gamma"][0])
    print(f"phase 38: compute_gamma's per-cell collision rates on the"
          f" step's first substep against float64 host sums of gamma x"
          f" xi_k: {rate_err} [{gpu}]")
    k4_err, seen = _k4_on_scans(real_k4, captured["k4"].values(), "phase 38")
    for line in seen:
        print(f"phase 38: K4 on a scan of the mixed-phase step {line}")
    k3_seen = k3_on_kept_solve(k3_kept[0], "phase 38")
    print(f"phase 38: K3 on the first solve of a mixed-phase step"
          f" ({k3_seen['drops']} drops in 625 cells): success equal to the"
          f" twin's, every log-mass inside the twin's interval for +-32 ulps"
          f" of qv; largest differences {k3_seen} [{gpu}]")

    # the shared sort carries the max row with its drop: a step with
    # collisions off (the sort still runs) leaves the multiset of (T_fz,
    # dry volume, kappa times dry volume) rows as it was
    names = ("freezing temperature", "dry volume", "kappa times dry volume")
    before = _sorted_rows(p, names)
    p.set_flag("collision_enable", False)
    p.run(1)
    p.set_flag("collision_enable", True)
    if not np.array_equal(_sorted_rows(p, names), before):
        raise AssertionError("phase 38: the sort lost a drop's max row")

    profile = _profile_steps(p, MG_PROFILED_STEPS, "mg2007")
    print(f"phase 38: {MG_PROFILED_STEPS} steps profiled: {profile}; the"
          f" shared sort kept each drop's freezing temperature with it"
          f" [{gpu}]")
    record.update(profile=profile, k4_max_abs_err=k4_err,
                  k3_vs_twin=k3_seen, launches=launches,
                  gamma_rates_vs_float64=rate_err)
    del p

    # the JAX test_mixed_phase_simulation at its size and bounds
    p, _ = mg2007_mixed_phase(None, MG_TEST_GRID, MG_TEST_SD_PER_CELL,
                              rhod_w_max=1.0, bigg=None)
    if "Freezing" not in p.dynamics or "freezing temperature" not in p.attributes:
        raise AssertionError("phase 38: the test case has no freezing")
    mass0 = float((p.attributes["multiplicity"]
                   * np.abs(p.attributes["signed water mass"])).sum())
    p.run(3)
    p.block_until_ready()
    signed = p.attributes["signed water mass"]
    mass1 = float((p.attributes["multiplicity"] * np.abs(signed)).sum())
    if not (np.isfinite(signed).all() and (signed > 0).all() and mass1 != mass0):
        raise AssertionError(f"phase 38: the JAX test's bounds: {mass0} {mass1}")
    print(f"phase 38: the JAX test's {MG_TEST_GRID} x {MG_TEST_SD_PER_CELL}"
          f" case on the card: finite, no ice, the water mass moved"
          f" ({mass0!r} -> {mass1!r}) [{gpu}]")
    return record


BARTMAN_SD_PER_CELL = (2**5, 2**8, 2**12)


def _bartman_on_card(gpu, phase10):
    """phase 39: ``bartman_et_al_2021.benchmark`` on the ``GPU`` backend, the
    25 x 25 warm rain at 2^5, 2^8 and 2^12 super-droplets per cell,
    ``WARM_RAIN_STEPS`` timed steps each. The timed window is the one the
    harness's clock sees, between its two ``block_until_ready`` (the end of
    the warm-up and the end of the steps): K2, K3 and K4 launches are set
    to 0 as it opens and read as it closes. At 2^12 the run is phase 10's
    (the same seed, warm-up and steps): its launches equal ``phase10``'s.
    At 2^5 and 2^8 one more step's K2 substep, K3 solve and K4 scans are
    held against their twins (``_column_kernels_vs_twins``; phase 10 holds
    them at 2^12). Returns {n_sd_per_gridbox: record}"""
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.models import bartman_et_al_2021 as model
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    windows, made = {}, {}
    real_make = model.make_simulation

    def counting_make(settings, **kwargs):
        p, spin_up = real_make(settings, **kwargs)
        run, block = p.run, p.block_until_ready
        window = {"steps": None}
        windows.setdefault(settings.n_sd_per_gridbox, []).append(window)

        def counted_run(steps):
            if window["steps"] is not None and "launches" not in window:
                window["steps"] += steps
            return run(steps)

        def marking_block():
            block()
            if window["steps"] is None:
                # the warm-up has ended: the harness starts its clock
                collision = p.dynamics["Collision"]
                solver = p.dynamics["Condensation"].solver
                window["before"] = (collision.substeps_run,
                                    solver.substep_solves, _host_reads(p))
                kern.coalesce_adjacent.launches = 0
                k3.masses_new.launches = 0
                scan.cumsum.launches = 0
                window["steps"] = 0
            elif "launches" not in window:
                # the steps have ended: the harness stops its clock
                collision = p.dynamics["Collision"]
                solver = p.dynamics["Condensation"].solver
                before = window["before"]
                window["launches"] = {
                    "coalesce_adjacent": kern.coalesce_adjacent.launches,
                    "masses_new": k3.masses_new.launches,
                    "cumsum": scan.cumsum.launches,
                    "collision substeps": collision.substeps_run - before[0],
                    "condensation solves": solver.substep_solves - before[1],
                    "host reads": _host_reads(p) - before[2],
                }

        p.run, p.block_until_ready = counted_run, marking_block
        made[settings.n_sd_per_gridbox] = p
        return p, spin_up

    records = {}
    with _replaced(model, "make_simulation", counting_make):
        for n_sd in BARTMAN_SD_PER_CELL:
            seconds = model.benchmark(
                backend_classes=(GPU,), n_sd_per_gridbox_list=(n_sd,),
                n_steps=WARM_RAIN_STEPS,
            )["GPU"][n_sd]
            p = made.pop(n_sd)
            window, = windows[n_sd]
            if window.get("steps") != WARM_RAIN_STEPS or "launches" not in window:
                raise AssertionError(f"phase 39: {n_sd}: the timed window {window}")
            counts = window["launches"]
            if (counts["coalesce_adjacent"] != counts["collision substeps"]
                    or counts["masses_new"] != counts["condensation solves"]
                    or counts["cumsum"] == 0):
                raise AssertionError(f"phase 39: {n_sd}: {counts}")
            per_step = {k: v / WARM_RAIN_STEPS for k, v in counts.items()}
            records[n_sd] = {"seconds": seconds,
                             "ms_per_step": seconds / WARM_RAIN_STEPS * 1e3,
                             "launches": counts, "per_step": per_step}
            print(f"phase 39: Bartman et al. 2021 sweep on GPU, 25 x 25 x"
                  f" {n_sd}: {seconds!r} s for {WARM_RAIN_STEPS} steps,"
                  f" {seconds / WARM_RAIN_STEPS * 1e3!r} ms/step; per step"
                  f" {per_step} [{gpu}]")
            if n_sd != BARTMAN_SD_PER_CELL[-1]:
                records[n_sd]["max_abs_err"] = _column_kernels_vs_twins(
                    p, gpu, label=f"phase 39 at {n_sd}"
                )
            del p
    at_full = records[BARTMAN_SD_PER_CELL[-1]]["launches"]
    same = {k: (at_full[k], phase10[k]) for k in phase10}
    if any(a != b for a, b in same.values()):
        raise AssertionError(f"phase 39: 2^12 launches against phase 10: {same}")
    print(f"phase 39: at 2^12 the launches equal phase 10's {phase10}"
          f" [{gpu}]")
    return records


PYRCEL_FULL_PER_MODE = 2**16
GP_FULL_N = 2**17
ARG_FULL_PER_MODE = 2**16


def pyrcel_settings(n_sd_per_mode):
    """``TestPyrcel``'s settings (two modes, dz 10 m, the 250 m ascent)"""
    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.initialisation import spectra
    from pysdm_tpu_torch.models import pyrcel

    return pyrcel.Settings(
        dz=10.0, n_sd_per_mode=(n_sd_per_mode, n_sd_per_mode),
        aerosol_modes_by_kappa={
            0.54: spectra.Lognormal(norm_factor=850e6, m_mode=15e-9, s_geom=1.6),
            1.2: spectra.Lognormal(norm_factor=10e6, m_mode=850e-9, s_geom=1.2),
        },
        vertical_velocity=1.0, initial_pressure=77500.0,
        initial_temperature=274.0, initial_relative_humidity=0.98,
        displacement=250.0, formulae=Formulae(constants={"MAC": 0.3}, seed=44),
    )


def _power_of_two(index):
    return index & (index - 1) == 0


def _activation_parcels(gpu):
    """phase 40: pyrcel, Grabowski & Pawlowska 2023 (pristine, polluted)
    and Abdul-Razzak & Ghan 2000 through their entry points on the card,
    at the JAX tests' sizes and at 2^16 per mode / 2^17, each JAX test's
    bounds, K3 launches = solves (``_model_window``); in each run the
    solves numbered 0, 1, 2, 4, ... kept and K3 held against its twin on
    the last of them (``k3_on_kept_solve``). Returns {case: record}"""
    import numpy as np

    from pysdm_tpu_torch.models import abdul_razzak_ghan_2000 as arg
    from pysdm_tpu_torch.models import grabowski_and_pawlowska_2023 as gp
    from pysdm_tpu_torch.models import pyrcel
    from pysdm_tpu_torch.ops.cuda import condensation as k3

    def held(kept, record, case):
        index = len(kept) - 1
        record["k3_vs_twin"] = {
            "solve": 0 if index == 0 else 2 ** (index - 1),
            **k3_on_kept_solve(kept[-1], f"phase 40: {case}"),
        }

    records = {}
    for per_mode in (16, PYRCEL_FULL_PER_MODE):
        settings = pyrcel_settings(per_mode)
        sim = pyrcel.Simulation(settings)
        with _keeping_calls(k3, "masses_new", _power_of_two) as kept:
            out, record = _model_window(sim.particulator, sim.run, settings.nt)
        held(kept, record, f"pyrcel {per_mode}")
        smax = float(np.nanmax(out["products"]["S_max"]))
        vol = out["attributes"]["volume"][-1]
        r_final = (3 * vol / 4 / np.pi) ** (1 / 3)
        if not (0.001 < smax < 0.01 and (r_final[per_mode:] > 1e-6).all()):
            raise AssertionError(f"phase 40: pyrcel {per_mode}: S_max {smax}")
        record["S_max"] = smax
        records[f"pyrcel_{2 * per_mode}"] = record
        print(f"phase 40: pyrcel, {2 * per_mode} super-droplets,"
              f" {settings.nt} steps: {record} [{gpu}]")
    for aerosol in ("pristine", "polluted"):
        for n_sd in (32, GP_FULL_N):
            settings = gp.Settings(aerosol=aerosol, vertical_velocity=1.0,
                                   dt=2.0, n_sd=n_sd, displacement=100.0)
            sim = gp.Simulation(settings)
            with _keeping_calls(k3, "masses_new", _power_of_two) as kept:
                out, record = _model_window(sim.particulator, sim.run, settings.nt)
            held(kept, record, f"G&P {aerosol} {n_sd}")
            s_max = float(np.nanmax(out["products"]["S_max"]))
            v0, v1 = out["attributes"]["volume"][0], out["attributes"]["volume"][-1]
            if not (0.0 < s_max < 0.05 and v1.sum() > v0.sum()
                    and np.isfinite(out["products"]["ripening rate"]).all()):
                raise AssertionError(f"phase 40: G&P {aerosol} {n_sd}: {s_max}")
            record["S_max"] = s_max
            records[f"gp_{aerosol}_{n_sd}"] = record
            print(f"phase 40: Grabowski & Pawlowska 2023 {aerosol}, {n_sd}"
                  f" super-droplets, {settings.nt} steps: {record} [{gpu}]")
    for per_mode in (16, ARG_FULL_PER_MODE):
        # run_parcel builds and runs in one call: its window holds the
        # build, and its particulator comes back with the result
        with _keeping_calls(k3, "masses_new", _power_of_two) as kept:
            t0 = time.perf_counter()
            out = arg.run_parcel(w=0.5, sol2=1.0, N2=100e6, rad2=50e-9,
                                 n_sd_per_mode=per_mode, n_steps=30)
            wall = time.perf_counter() - t0
            launches = k3.masses_new.launches
        solver = out.particulator.dynamics["Condensation"].solver
        s, v = out.activated_fraction_S, out.activated_fraction_V
        if launches != solver.substep_solves:
            raise AssertionError(f"phase 40: ARG K3 {launches}"
                                 f" launches for {solver.substep_solves} solves")
        if not (abs(s[0] - s[1]) <= 0.12 and 0.05 < s[0] < 0.95
                and (np.abs(s - v) <= 0.25).all()):
            raise AssertionError(f"phase 40: ARG {per_mode}: {s} {v}")
        record = {"k3_launches": launches,
                  "solves": solver.substep_solves,
                  "ms_per_step_with_build": wall / 30 * 1e3,
                  "solver_reads_per_step": solver.host_reads / 30,
                  "activated_fraction_S": s.tolist(),
                  "activated_fraction_V": v.tolist()}
        held(kept, record, f"ARG {per_mode}")
        records[f"arg_{2 * per_mode}"] = record
        print(f"phase 40: Abdul-Razzak & Ghan 2000, {2 * per_mode}"
              f" super-droplets, 30 steps: {record} [{gpu}]")
    return records


ARABAS_2025_N = 2**17
ARABAS_2025_STEPS = 60


def arabas_2025_run(n_sd, singular, cooling_rate, backend=None):
    """the JAX test's ``_run`` of Arabas et al. 2025 (a 10 um droplet per
    particle, 1e6 of them in 1 m^3 for its 256 super-droplets, 60 steps
    from 250 K to 230 K) through ``make_particulator`` and
    ``run_simulation``, the box and its particles scaled with ``n_sd``
    (above 256 the test's 1e6 would leave multiplicities of a few, which
    the builder refuses to round); returns (output, frozen fraction per
    step, wall seconds of run_simulation)"""
    import numpy as np

    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.models import arabas_et_al_2025 as model

    droplet_volume = float(Formulae().trivia.volume(radius=10e-6))
    scale = max(1.0, n_sd / 256)
    dt = (model.TEMP_RANGE[0] - model.TEMP_RANGE[1]) / -cooling_rate / ARABAS_2025_STEPS
    kwargs = {} if backend is None else {"backend_class": backend}
    p = model.make_particulator(
        constants=model.FREEZING_CONSTANTS["dust"], n_sd=n_sd, dt=dt,
        initial_temperature=model.TEMP_RANGE[0], singular=singular, seed=44,
        shima_T_fz="Niemand_et_al_2012", ABIFM_spec=model.abifm_spec(),
        droplet_volume=droplet_volume, total_particle_number=1e6 * scale,
        volume=scale, **kwargs,
    )
    profile = lambda t: model.TEMP_RANGE[0] + cooling_rate * t
    t0 = time.perf_counter()
    out = model.run_simulation(p, profile, ARABAS_2025_STEPS)
    wall = time.perf_counter() - t0
    ff = model.FrozenFraction(volume=scale, droplet_volume=droplet_volume,
                              total_particle_number=1e6 * scale,
                              rho_w=p.formulae.constants.rho_w)
    return out, np.asarray([ff.qi2ff(qi) for qi in out["products"]["qi"]]), wall


def _arabas_2025_on_card(gpu):
    """phase 41: Arabas et al. 2025 on the card at 2^17, singular and
    time-dependent at the three cooling rates of the JAX tests, with the
    four tests' bounds. Returns {case: ms/step}"""
    import numpy as np

    from pysdm_tpu_torch.models import arabas_et_al_2025 as model

    ff, records = {}, {}
    for singular in (True, False):
        for rate in model.COOLING_RATES:
            _, ff[singular, rate], wall = arabas_2025_run(
                ARABAS_2025_N, singular, rate
            )
            f = ff[singular, rate]
            if not (f[0] == 0 and (np.diff(f) >= -1e-12).all()):
                raise AssertionError(f"phase 41: {singular} {rate}: {f}")
            key = f"{'singular' if singular else 'ABIFM'} {rate * 60!r} K/min"
            records[key] = {"ms_per_step": wall / ARABAS_2025_STEPS * 1e3,
                            "frozen_fraction_end": float(f[-1])}
    mid, (fast, medium, slow) = 30, model.COOLING_RATES
    checks = {
        "singular ends above 0.9": ff[True, medium][-1] > 0.9,
        "time-dependent ends above 0.5": ff[False, medium][-1] > 0.5,
        "singular rate-independent": abs(ff[True, fast][mid] - ff[True, slow][mid]) <= 0.05,
        "ABIFM freezes more when slower": ff[False, slow][mid] > ff[False, fast][mid] + 0.05,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 41: {failed}: {records}")
    print(f"phase 41: Arabas et al. 2025, {ARABAS_2025_N} super-droplets,"
          f" {ARABAS_2025_STEPS} steps each, the four tests' bounds hold:"
          f" {records} [{gpu}]")
    return records


SEEDING_INITIAL_N = 2**17
SEEDING_POOL_N = 2**12
RELAXED_N = 2**17


def seeding_rate(dt, pool=SEEDING_POOL_N):
    """``pool`` super-droplets per 100 s within the 300-400 s window, as a
    count per step of ``dt``"""
    import numpy as np

    return lambda t: np.where((t >= 300.0) & (t < 400.0), pool * dt / 100.0, 0.0)


SEEDING_KEPT_T = 330.0


def seeding_window(sim):
    """``sim.run`` (the seeding parcel) in ``_model_window``, keeping the
    first K1 substep and the first K3 solve at or after ``SEEDING_KEPT_T``
    on the parcel's host clock, two steps into the injection; returns
    (output, record, {"k1": kept, "k3": kept})"""
    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.ops.cuda import condensation as k3

    p = sim.particulator

    def injecting(_):
        return p.sim_state["host"]["t"] >= SEEDING_KEPT_T

    with contextlib.ExitStack() as stack:
        k1_kept = stack.enter_context(
            _keeping_calls(collision, "coalesce_mirror", injecting, limit=1)
        )
        k3_kept = stack.enter_context(
            _keeping_calls(k3, "masses_new", injecting, limit=1)
        )
        out, record = _model_window(p, sim.run, sim.n_steps)
    return out, record, {"k1": k1_kept, "k3": k3_kept}


def seeding_kernels_vs_twins(kept, n_sd_initial, label):
    """``seeding_window``'s kept K1 substep and K3 solve, each holding
    injected drops and graves (multiplicity 0), against their twins
    (``k1_on_kept_substep``, ``k3_on_kept_solve``); returns
    {"k1_vs_twin": ..., "k3_vs_twin": ...}"""
    from pysdm_tpu_torch.ops.cuda import collision as kern

    if not (kept["k1"] and kept["k3"]):
        raise AssertionError(f"{label}: no substep or solve kept: {kept}")
    args = kept["k1"][0][0]
    live = int((args[0] > 0).sum())
    if not (n_sd_initial < live < args[0].shape[0] and args[3] == kern.GEOMETRIC):
        raise AssertionError(
            f"{label}: the kept K1 substep has {live} live slots of"
            f" {args[0].shape[0]}, kernel {args[3]}"
        )
    k3_seen = k3_on_kept_solve(kept["k3"][0], label)
    if not n_sd_initial + k3_seen["graves"] < k3_seen["drops"]:
        raise AssertionError(f"{label}: the kept K3 solve has no injected drop")
    if not k3_seen["graves"] > 0:
        raise AssertionError(f"{label}: the kept K3 solve has no grave")
    return {"k1_vs_twin": k1_on_kept_substep(args, label), "k3_vs_twin": k3_seen}


def _seeding_on_card(gpu):
    """phase 42: the seeding parcel (``models/seeding.py``) at 2^17 + a pool
    of 2^12 graves, collisions on (K1, Geometric), through ``Simulation.run``:
    the JAX test's bounds, the super-droplet count up by exactly what was
    injected (the pool's 2^12: the last injecting step finds fewer graves
    than it asks for), K1 launches = collision substeps and K3 = solves,
    condensation's success; the first K1 substep and K3 solve two steps
    into the injection against their twins; then a 2^17 box with
    ``RelaxedVelocity`` at the JAX test's bound"""
    import numpy as np

    from pysdm_tpu_torch import Builder, Formulae
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.dynamics import RelaxedVelocity
    from pysdm_tpu_torch.dynamics.terminal_velocity import gunn_kinzer_v_term
    from pysdm_tpu_torch.environments import Box
    from pysdm_tpu_torch.initialisation import init_fall_momenta
    from pysdm_tpu_torch.models import seeding

    settings = seeding.Settings(
        super_droplet_injection_rate=seeding_rate(15.0),
        formulae=Formulae(seed=44), n_sd_initial=SEEDING_INITIAL_N,
        n_sd_seeding=SEEDING_POOL_N,
    )
    sim = seeding.Simulation(settings)
    p = sim.particulator
    if p.device.type != "cuda" or p.dynamics["Collision"].route() != "k1":
        raise AssertionError(f"phase 42: {p.device}, {p.dynamics['Collision'].route()}")
    out, record, kept = seeding_window(sim)
    sd_count = out["products"]["sd_count"]
    # each step's ask, as many as the graves left take; coalescence later
    # empties slots (multiplicity 0), so the count is held up to the end of
    # the window, where no drop has died yet
    rate, graves, expected = seeding_rate(15.0), SEEDING_POOL_N, [SEEDING_INITIAL_N]
    for step in range(1, sim.n_steps + 1):
        placed = min(int(rate(15.0 * step)), graves)
        graves -= placed
        expected.append(expected[-1] + placed)
    end = int(400.0 // 15.0) + 1
    injected = expected[end] - SEEDING_INITIAL_N
    checks = {
        "sd_count starts at n_sd_initial": sd_count[0] == SEEDING_INITIAL_N,
        "sd_count up by the injected": list(sd_count[:end + 1]) == expected[:end + 1],
        "every grave filled": injected == SEEDING_POOL_N,
        "sd_count above n_sd_initial at the end": sd_count[-1] > SEEDING_INITIAL_N,
        "r_eff above 1 um": np.nanmax(out["products"]["r_eff"]) > 1e-6,
        "collisions ran": record["collision_substeps"] >= sim.n_steps,
        "condensation success": p.get_counter("condensation_success").all(),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 42: {failed}: {record}, sd_count {sd_count}")
    record.update(injected=injected,
                  r_eff_max=float(np.nanmax(out["products"]["r_eff"])))
    print(f"phase 42: seeding parcel, {SEEDING_INITIAL_N} + {SEEDING_POOL_N}"
          f" graves, {sim.n_steps} steps, collisions on: {record};"
          f" sd_count {int(sd_count[0])} -> {int(sd_count[-1])} [{gpu}]")
    record.update(seeding_kernels_vs_twins(kept, SEEDING_INITIAL_N, "phase 42"))
    print(f"phase 42: on the first K1 substep and the first K3 solve from"
          f" t = {SEEDING_KEPT_T} s, injected drops and graves side by side:"
          f" K1 xi equal to the twin, rows within rtol 1e-6, rates within"
          f" 1e-5, (slots changed, rows' max abs err) {record['k1_vs_twin']};"
          f" K3's success equal to the twin's, every log-mass inside its"
          f" interval for +-32 ulps of qv, the graves' results equal,"
          f" {record['k3_vs_twin']} [{gpu}]")

    formulae = Formulae(seed=6)
    builder = Builder(n_sd=RELAXED_N, backend=GPU(formulae),
                      environment=Box(dt=0.1, dv=1.0))
    builder.add_dynamic(RelaxedVelocity(c=8.0))
    water_mass = np.geomspace(1e-12, 1e-7, RELAXED_N)
    p = builder.build({
        "multiplicity": np.ones(RELAXED_N), "water mass": water_mass,
        "relative fall momentum": init_fall_momenta(water_mass, formulae, zero=True),
    })
    t0 = time.perf_counter()
    p.run(205)
    p.block_until_ready()
    wall = time.perf_counter() - t0
    v = p.get_attribute("relative fall velocity")
    v_term = gunn_kinzer_v_term(p.get_attribute("radius"))
    err = float(((v - v_term).abs() / v_term).max())
    if not err < 1e-3:
        raise AssertionError(f"phase 42: relaxed velocity off by {err}")
    relaxed = {"ms_per_step": wall / 205 * 1e3, "max_rel_err": err}
    print(f"phase 42: RelaxedVelocity box, {RELAXED_N} drops, 205 steps of"
          f" 0.1 s: {relaxed}, within rtol 1e-3 of the terminal velocity"
          f" [{gpu}]")
    record["relaxed_velocity"] = relaxed
    return record


# --- phases 43-45: chemistry and isotopes -----------------------------------
KW_N = 2**17
# the first 400 s of the ascent (cloud base near 196 s): the whole 2596 s
# would take ~6 min at the chemistry's eager launches (PERF.md §4)
KW_WINDOW = 400.0
KW_PROFILED_STEPS = 3
KW_F32_N = 2**10
# 250 s: four 10 s outputs in cloud (from ~220 s) for the liquid-water
# comparison; 300 s put the script past ~800 s on a slow host
KW_F32_WINDOW = 250.0
# phase 43b's bounds, set before its first run (PERF.md §6): pH
# absolute, the rest relative; liquid water where it exceeds 1e-5 kg/kg
KW_F32_BOUNDS = {"pH": 0.01, "gas_S_IV": 0.01, "aq_S_VI": 0.01,
                 "liquid water mixing ratio": 0.01}
# a Kreidenweis step at KW_N and 5 substeps launched 18,765 kernels with
# the eager pH solve (PERF.md §5); with the pH kernel, at most this many
KW_KERNELS_PER_STEP_MAX = 4500
# float32 operations charged to the pH kernel's bound (csrc/chemistry.cu):
# 36 an iteration (the exp, six divisions and the comparison one each), 11
# a drop besides (the H-free factors, the result's exp); 12 rows read and
# H written a drop
PH_OPS_PER_ITERATION = 36
PH_OPS_PER_DROP = 11
PH_VALUES_PER_DROP = 13
# phase 43 holds the pH kernel to its twin on its kept solve and on the same
# drops this many times over (2^20 at 2^17), at these iteration counts (47:
# a last round of fewer levels)
PH_WIDE_REPEATS = 8
PH_CHECKED_ITERATIONS = (0, 1, 47, 48)
JP_N = 2**17
# Jaruga & Pawlowska 2018 fig. 2 at their finest resolution, as the JAX
# test quotes it (``tests/smoke/test_models.py:310-311``)
JP_PAPER = {"S_max_percent": (0.24, 0.61), "pH": (4.7, 5.2)}
# Rozanski & Sonntag's parcel on the card: the first six 180 m levels of
# the 7.2 km ascent, three of them in cloud (base at the third)
ROZANSKI_Z = 1080.0
# the parcel's K3 solves kept for the check against the twin (~450 a level)
ROZANSKI_KEEP_EVERY = 256
# float32 on the card against float64 on the host, each isotope formula,
# the error over the largest float64 value of its sample (set before the
# first run from a float32 CPU evaluation of these inputs, 6.0e-6 at
# most; PERF.md §6)
ISOTOPE_F32_BOUND = 5e-5
ISOTOPE_FAMILIES = {
    "isotope_equilibrium_fractionation_factors": "EQUILIBRIUM_VARIANTS",
    "isotope_kinetic_fractionation_factors": "KINETIC_VARIANTS",
    "isotope_diffusivity_ratios": "DIFFUSIVITY_RATIO_VARIANTS",
    "isotope_meteoric_water_line": "MWL_VARIANTS",
    "isotope_ratio_evolution": "RATIO_EVOLUTION_VARIANTS",
    "isotope_relaxation_timescale": "RELAXATION_TIMESCALE_VARIANTS",
    "isotope_temperature_inference": "TEMPERATURE_INFERENCE_VARIANTS",
    "isotope_ventilation_ratio": "VENTILATION_RATIO_VARIANTS",
}


def isotope_arguments(n, seed=13):
    """each isotope formula's arguments by name over the ranges the isotope
    models use, away from the poles of ``ZabaEtAl`` and
    ``GedzelmanAndArnold1994`` (subsaturated exchange, vapour lighter than
    the rain)"""
    import numpy as np

    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, n)

    args = {
        "T": u(230.0, 310.0), "temperature": u(230.0, 310.0),
        "_": np.full(n, np.nan), "alpha_l_18O": u(1.005, 1.02),
        "relative_humidity": u(0.0, 1.0), "turbulence_parameter_n": u(0.5, 1.0),
        "delta_diff": u(0.01, 0.05), "theta": u(0.5, 1.0),
        "alpha_equilibrium": u(1.0, 1.2), "saturation": u(1.0, 1.4),
        "D_ratio_heavy_to_light": u(0.97, 0.99), "delta_17O": u(-0.05, 0.01),
        "delta_18O": u(-0.1, 0.02), "delta_2H": u(-0.4, 0.0),
        "alpha": u(1.0, 1.1), "d_alpha": u(-1e-5, 1e-5),
        "n_vapour": u(1e-3, 2e-2), "d_n_vapour": u(-1e-5, 0.0),
        "n_liquid": u(1e-4, 1e-3), "X_over_X0": u(0.05, 1.0),
        "a": u(1.0, 1.1), "diff_rat": u(1.0, 1.03),
        "iso_ratio_x": u(1.5e-4, 2e-4), "iso_ratio_r": u(1.5e-4, 2e-4),
        "iso_ratio_v": u(0.5e-4, 0.8e-4), "b": u(0.5, 1.0),
        "alpha_w": u(1.0, 1.1), "dm_dt_over_m": u(1e-3, 1.0),
        "rho_s": u(3e-3, 3e-2), "radius": np.exp(u(np.log(1e-5), np.log(2e-3))),
        "D_iso": u(2e-5, 3e-5), "D": u(2e-5, 3e-5), "S": u(0.5, 0.9),
        "R_liq": u(0.9, 1.1), "Fk": u(1e8, 1e10),
        "ventilation_coefficient": u(1.0, 10.0),
        "diffusivity_ratio": u(0.97, 1.03),
    }
    args["R_vap"] = args["R_liq"] / args["alpha"] * 0.99
    return args


def kreidenweis_settings(n_sd, t_max, dt=1.0, n_substep=5):
    """``kreidenweis_et_al_2003.Settings`` with ``run_convergence_point``'s
    default dt and substeps, over the first ``t_max`` seconds"""
    from pysdm_tpu_torch.models import kreidenweis_et_al_2003 as kw

    settings = kw.Settings(dt=dt, n_sd=n_sd, n_substep=n_substep)
    settings.t_max = t_max
    return settings


def ph_solve_inputs(n, seed):
    """inputs of the pH solve for ``n`` drops, as float64 numpy arrays:
    (concentrations by ``CONC_ROWS``' names, equilibrium constants by
    ``K_ROWS``' names, the host floats K_H2O, H_min and H_max as the
    chemistry dynamic passes them). Concentrations log-uniform over acid
    to alkaline drops (S(VI) and N(-III) from 1e-9 to 1e4 mol/m3), the
    constants at cell temperatures from 263 to 303 K; every eighth drop
    holds nothing (pure water), the next is dead (its amounts over the
    1e-30 m3 the dynamic puts in place of its volume) and the next lacks
    one compound"""
    import numpy as np
    import torch

    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.dynamics.impl import chemistry_utils as chem

    rng = np.random.default_rng(seed)

    def log_uniform(lo, hi):
        return np.exp(rng.uniform(np.log(lo), np.log(hi), n))

    conc = {
        "S_VI": log_uniform(1e-9, 1e4), "S_IV": log_uniform(1e-12, 1e-1),
        "C_IV": log_uniform(1e-9, 1e-2), "N_V": log_uniform(1e-12, 1e-1),
        "N_mIII": log_uniform(1e-9, 1e4),
    }
    volume = 4 / 3 * np.pi * log_uniform(3e-8, 2e-5) ** 3
    names = list(conc)
    for i, name in enumerate(names):
        conc[name][0::8] = 0.0
        conc[name][1::8] *= volume[1::8] / 1e-30
        conc[name][2 + i:: 8 * len(names)] = 0.0
    formulae = Formulae()
    T = torch.from_numpy(rng.uniform(263.0, 303.0, n))
    K = {k: v.at(T).numpy() for k, v in chem.equilibrium_consts(formulae).items()}
    host = {
        "K_H2O": formulae.constants.K_H2O,
        "H_min": float(formulae.trivia.pH2H(14.0)),
        "H_max": float(formulae.trivia.pH2H(-1.0)),
    }
    return conc, K, host


def ph_parting_bracket(conc, K, host, iters=48, ulps=2):
    """per drop, how far apart in log H two runs of the pH bisection can
    end whose exps differ by at most ``ulps`` ulps: the twin's bisection
    (``equilibrate_H_reference``, on the inputs' device and dtype) run
    again, and at each midpoint the residual's sign also taken at every
    float up to ``ulps`` ulps below and above exp(mid) (the float32
    residual's sign is not monotone across neighbouring floats near its
    root). Until a midpoint where those signs differ, two such runs take
    the same steps; from there each stays inside that iteration's
    bracket. Returns that bracket's width (hi - lo) at the first such
    midpoint, or the last bracket's where there is none, as a float64
    numpy array"""
    import math

    import torch

    from pysdm_tpu_torch.ops.cuda import chemistry as ph

    terms = ph.acidity_terms(conc, K)
    lo = torch.full_like(conc["S_VI"], math.log(host["H_min"]))
    hi = torch.full_like(conc["S_VI"], math.log(host["H_max"]))
    parted = torch.zeros_like(lo, dtype=torch.bool)
    width = torch.zeros_like(lo)
    zero, inf = torch.zeros_like(lo), torch.full_like(lo, math.inf)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        H = down = up = torch.exp(mid)
        go_lo = ph.acidity_residual(H, terms, host["K_H2O"]) > 0
        parts = torch.zeros_like(parted)
        for _ in range(ulps):
            down, up = torch.nextafter(down, zero), torch.nextafter(up, inf)
            for h in (down, up):
                parts |= (ph.acidity_residual(h, terms, host["K_H2O"]) > 0) != go_lo
        width = torch.where(parts & ~parted, hi - lo, width)
        parted |= parts
        hi = torch.where(go_lo, mid, hi)
        lo = torch.where(go_lo, lo, mid)
    width = torch.where(parted, width, hi - lo)
    return width.cpu().double().numpy()


def ph_parting_width(got, want, conc, K, host, iters):
    """``ph_parting_bracket`` where the kernel's H (``got``) and the twin's
    (``want``) differ anywhere, else zeros: a bit-equal solve needs no
    bracket"""
    import numpy as np
    import torch

    if torch.equal(got, want):
        return np.zeros(got.numel())
    return ph_parting_bracket(conc, K, host, iters)


def compare_ph_solves(got, want, width, label):
    """the pH kernel's H (``got``) against its twin's (``want``), tensors of
    one dtype: equal to the bit, or apart in log H by at most ``width``
    (``ph_parting_bracket``) and the final exp's rounding (2 ulps of H in
    either, 4 eps); returns the drops that differ, the largest difference
    in log H and its ratio to its drop's bound"""
    import numpy as np

    eps = float(np.finfo(np.float32 if got.dtype.itemsize == 4
                         else np.float64).eps)
    g, w = got.cpu().double().numpy(), want.cpu().double().numpy()
    differ = (g != w) & ~(np.isnan(g) & np.isnan(w))
    d = np.abs(np.log(g[differ]) - np.log(w[differ]))
    bound = width[differ] + 4 * eps + 4 * np.spacing(np.abs(np.log(w[differ])))
    if not (d <= bound).all():
        worst = int(np.argmax(d / bound))
        raise AssertionError(
            f"{label}: the pH kernel's log H {float(d[worst])!r} from its"
            f" twin's, beyond its bound {float(bound[worst])!r}"
            f" ({int((d > bound).sum())} drops)"
        )
    return {
        "drops": int(g.size), "differ": int(differ.sum()),
        "max_abs_err_log_H": float(d.max()) if d.size else 0.0,
        "max_err_over_bound": float((d / bound).max()) if d.size else 0.0,
    }


def ph_on_kept_solve(kept, label):
    """the pH kernel on a kept solve's inputs (``_keeping_calls`` of
    ``ops.chemistry.equilibrate_H``) and on the same drops eight times over
    (2^20 at the Kreidenweis parcel's 2^17), in the kept dtype and in the
    other, at ``PH_CHECKED_ITERATIONS``, against its twin on the same device
    (``compare_ph_solves``): drops that differ and the largest difference
    at each; then the kernel's device time at both widths (the kept dtype,
    the kept iterations), the twin's and the bounds: the bytes of 13 values
    a drop and the operations of its iterations; the built form"""
    import torch

    from pysdm_tpu_torch.ops.cuda import chemistry as ph

    _, solve = kept
    iters = solve.get("iters", ph.PH_ITERATIONS)
    host = {k: solve[k] for k in ("K_H2O", "H_min", "H_max")}

    def with_rows(case, fn):
        """``case`` with ``fn`` applied to its rows (the dynamic passes
        K_H2O, a host float, among the constants too)"""
        return {**case, **{key: {
            k: fn(v) if torch.is_tensor(v) else v for k, v in case[key].items()
        } for key in ("conc", "K_drop")}}

    widths = {"": solve,
              "_2_20": with_rows(solve, lambda v: v.repeat(PH_WIDE_REPEATS))}
    other = (torch.float64 if solve["conc"]["S_VI"].dtype == torch.float32
             else torch.float32)
    checks, seen = {}, None
    for suffix, wide in widths.items():
        for dtype in (solve["conc"]["S_VI"].dtype, other):
            case = with_rows(wide, lambda v, d=dtype: v.to(d))
            for n_iter in PH_CHECKED_ITERATIONS:
                case["iters"] = n_iter
                got = ph.equilibrate_H(**case)
                want = ph.equilibrate_H_reference(**case)
                width = ph_parting_width(got, want, case["conc"],
                                         case["K_drop"], host, n_iter)
                record = compare_ph_solves(
                    got, want, width,
                    f"{label}, {got.numel()} drops, {dtype}, {n_iter} iterations",
                )
                checks[f"{got.numel()} {str(dtype)[6:]} {n_iter}"] = (
                    record["differ"], record["max_abs_err_log_H"]
                )
                if suffix == "" and dtype != other and n_iter == iters:
                    seen = record
    seen.update({"checks": checks,
                 "dtype": str(solve["conc"]["S_VI"].dtype)})
    for suffix, wide in widths.items():
        n = wide["conc"]["S_VI"].numel()
        item = wide["conc"]["S_VI"].element_size()
        bound = bound_ms(n * PH_VALUES_PER_DROP * item,
                         n * (iters * PH_OPS_PER_ITERATION + PH_OPS_PER_DROP))
        seen.update({
            "ms" + suffix: _time_ms(torch, lambda w=wide: ph.equilibrate_H(**w),
                                    200 if suffix == "" else 50),
            "bound_ms" + suffix: bound[0], "bound_by" + suffix: bound[1],
        })
    seen["plain_ms"] = _time_ms(
        torch, lambda: ph.equilibrate_H_reference(**solve), 5
    )
    return seen


def _nonfinite_chemistry(p):
    """every aqueous amount of a live drop and every trace-gas row finite"""
    import numpy as np

    from pysdm_tpu_torch.dynamics.impl.chemistry_utils import (
        AQUEOUS_COMPOUNDS, GASEOUS_COMPOUNDS,
    )

    alive = p.attributes["multiplicity"] > 0
    bad = [k for k in AQUEOUS_COMPOUNDS
           if not np.isfinite(p.attributes[f"moles_{k}"][alive]).all()]
    bad += [c for c in GASEOUS_COMPOUNDS.values()
            if not np.isfinite(p.get_env(f"chem_{c}")).all()]
    return bad


def acidity_minfun_verbatim(H, conc, K, K_H2O):
    """``pysdm_tpu/ops/chemistry.py`` ``acidity_minfun``'s body in torch:
    every factor formed again at each call"""
    ammonia = (conc["N_mIII"] * H * K["K_NH3"]) / (K_H2O + K["K_NH3"] * H)
    nitric = conc["N_V"] * K["K_HNO3"] / (H + K["K_HNO3"])
    sulfous = (
        conc["S_IV"]
        * K["K_SO2"]
        * (H + 2 * K["K_HSO3"])
        / (H * H + H * K["K_SO2"] + K["K_SO2"] * K["K_HSO3"])
    )
    water = K_H2O / H
    sulfuric = conc["S_VI"] * (H + 2 * K["K_HSO4"]) / (H + K["K_HSO4"])
    carbonic = (
        conc["C_IV"]
        * K["K_CO2"]
        * (H + 2 * K["K_HCO3"])
        / (H * H + H * K["K_CO2"] + K["K_CO2"] * K["K_HCO3"])
    )
    return H + ammonia - (nitric + sulfous + water + sulfuric + carbonic)


def equilibrate_H_verbatim(*, conc, K_drop, K_H2O, H_min, H_max, iters=48):
    """``pysdm_tpu/ops/chemistry.py`` ``equilibrate_H`` in torch"""
    import math

    import torch

    lo = torch.full_like(conc["S_VI"], math.log(H_min))
    hi = torch.full_like(conc["S_VI"], math.log(H_max))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_lo = acidity_minfun_verbatim(torch.exp(mid), conc, K_drop, K_H2O) > 0
        hi = torch.where(go_lo, mid, hi)
        lo = torch.where(go_lo, lo, mid)
    return torch.exp(0.5 * (lo + hi))


def _pH_solve_forms(p, solve, steps=KW_PROFILED_STEPS):
    """phase 43's pH solve in three forms on ``p``'s next steps: the kernel
    (``ops/cuda/chemistry.py`` ``equilibrate_H``), its eager twin
    (``equilibrate_H_reference``, the residual's H-free factors formed once
    a solve) and the JAX package's body as it stands
    (``equilibrate_H_verbatim``). On ``solve`` (a kept solve's keyword
    arguments) the twin and the JAX body give the same H to the bit; then
    ``steps`` steps with each form in turn, twice (host ms/step, and the
    chemistry's ms by the per-dynamic timers); then the device kernels a
    step of each (``_profile_steps`` over 1 + 1 steps)"""
    import torch

    from pysdm_tpu_torch.ops import chemistry as chem_ops
    from pysdm_tpu_torch.ops.cuda import chemistry as ph

    forms = {"kernel": ph.equilibrate_H, "split": ph.equilibrate_H_reference,
             "verbatim": equilibrate_H_verbatim}
    H = {name: forms[name](**solve) for name in ("split", "verbatim")}
    if not torch.equal(H["split"], H["verbatim"]):
        raise AssertionError(
            "phase 43: the two eager pH solve forms differ by up to"
            f" {float((H['split'] - H['verbatim']).abs().max())!r}"
        )
    rounds = {name: [] for name in forms}
    for name in (*forms, *forms):
        with _replaced(chem_ops, "equilibrate_H", forms[name]):
            p.timers = {}
            p.enable_per_dynamic_timing()
            p.run(steps)
            p.enable_per_dynamic_timing(False)
        rounds[name].append({
            "ms_per_step": p.timers["total"] / steps * 1e3,
            "chemistry_ms": p.timers["AqueousChemistry"] / steps * 1e3,
        })
    profiles = {}
    for name, form in forms.items():
        with _replaced(chem_ops, "equilibrate_H", form):
            profiles[name] = _profile_steps(p, 1, f"kreidenweis_pH_{name}")
    return {"eager_H_bit_equal": True, "timed": rounds,
            "kernels_per_step": {k: v["kernels_per_step"] for k, v in profiles.items()},
            "profiled": profiles}


def _kreidenweis_on_card(gpu, n_sd=KW_N, window=KW_WINDOW):
    """phase 43: ``kreidenweis_et_al_2003.Simulation`` with the default
    backend (the card) at ``run_convergence_point``'s dt = 1 s and 5
    substeps, over the first ``window`` seconds: the JAX test's bounds at
    the window's end, S(VI) grown, every amount and gas row finite, K3
    launches = solves, the pH kernel's and K4's launches counted (the pH
    kernel's at least two a substep); then one more step's first K3 solve
    and first pH solve, in cloud, against their twins, and each timed with
    its twin beside its bound; 3 steps timed dynamic by dynamic (the pH
    kernel launched twice a substep) and 3 + 3 profiled (at most
    ``KW_KERNELS_PER_STEP_MAX`` kernels a step); the pH solve's three forms
    timed (``_pH_solve_forms``)"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.models import kreidenweis_et_al_2003 as kw
    from pysdm_tpu_torch.ops import chemistry as chem_ops
    from pysdm_tpu_torch.ops.cuda import chemistry as ph
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    settings = kreidenweis_settings(n_sd, window)
    sim = kw.Simulation(settings)
    p = sim.particulator
    if p.device.type != "cuda":
        raise AssertionError(f"phase 43: the default backend is {p.device}")
    scan.cumsum.launches = ph.equilibrate_H.launches = 0
    out, record = _model_window(p, sim.run, settings.nt)
    record["k4_launches"] = scan.cumsum.launches
    record["pH_launches"] = ph.equilibrate_H.launches
    series = {k: np.asarray(v) for k, v in out.items()}
    checks = {
        "3 < pH < 6": 3.0 < series["pH"][-1] < 6.0,
        "gas S(IV) below its start": series["gas_S_IV"][-1] < series["gas_S_IV"][0],
        "liquid water above 1e-5": series["liquid water mixing ratio"][-1] > 1e-5,
        "S(VI) grown": series["aq_S_VI"][-1] > series["aq_S_VI"][0],
        "series finite past cloud base": all(
            np.isfinite(v[-10:]).all() for v in series.values()
        ),
        "condensation success": p.get_counter("condensation_success").all(),
        "pH kernel: two launches a substep or more": (
            record["pH_launches"] >= 2 * settings.n_substep * settings.nt
        ),
    }
    failed = [k for k, ok in checks.items() if not ok]
    failed += [f"not finite: {k}" for k in _nonfinite_chemistry(p)]
    if failed:
        raise AssertionError(f"phase 43: {failed}: {record}")
    record.update({k: float(v[-1]) for k, v in series.items() if k != "t"})
    print(f"phase 43: Kreidenweis et al. 2003 at {n_sd} super-droplets,"
          f" dt = 1 s, 5 chemistry substeps, {settings.nt} steps to"
          f" t = {window} s on the card: {record} [{gpu}]")
    with _keeping_calls(k3, "masses_new", lambda i: i == 0, limit=1) as kept, \
            _keeping_calls(chem_ops, "equilibrate_H", lambda i: i == 0,
                           limit=1) as kept_pH:
        p.run(1)
    record["k3_vs_twin"] = k3_on_kept_solve(kept[0], "phase 43")
    record["pH_vs_twin"] = ph_on_kept_solve(kept_pH[0], "phase 43")
    pH = record["pH_vs_twin"]
    threads = _source_constant("chemistry.cu", "THREADS")
    print(f"phase 43: the pH kernel ({threads} threads a block) on the first"
          f" solve from"
          f" t = {window} s (in cloud) against its twin: {pH['differ']} of"
          f" {pH['drops']} drops differ, largest |d log H|"
          f" {pH['max_abs_err_log_H']!r}; at 2^17 and 2^20 drops, float32"
          f" and float64, {PH_CHECKED_ITERATIONS} iterations, (drops that"
          f" differ, largest |d log H|): {pH['checks']}; kernel {pH['ms']!r}"
          f" ms, at 2^20 {pH['ms_2_20']!r} ms, twin {pH['plain_ms']!r} ms,"
          f" bound {pH['bound_ms']!r} ms ({pH['bound_by']}), at 2^20"
          f" {pH['bound_ms_2_20']!r} ms [{gpu}]")
    # K3's time on that solve, its twin's, and its bound: 29 B a drop and
    # the minfun evaluations these drops need
    (formulae, k3_settings, *rows), optional = kept[0]
    evaluations = k3_evaluations(k3, formulae, k3_settings, rows, extra=optional)
    bound = bound_ms(rows[0].shape[0] * 29, evaluations * K3_OPS_PER_MINFUN)
    record["k3_on_solve"] = {
        "ms": _time_ms(torch, lambda: k3.masses_new(
            formulae, k3_settings, *rows, **optional), 200),
        "plain_ms": _time_ms(torch, lambda: k3.masses_new_reference(
            formulae, k3_settings, *rows, **optional), 5),
        "bound_ms": bound[0], "bound_by": bound[1],
        "minfun_evaluations": evaluations,
    }
    p.timers = {}
    p.enable_per_dynamic_timing()
    ph.equilibrate_H.launches = 0
    p.run(KW_PROFILED_STEPS)
    record["pH_launches_per_step"] = ph.equilibrate_H.launches / KW_PROFILED_STEPS
    p.enable_per_dynamic_timing(False)
    record["ms_per_dynamic"] = {
        name: t / KW_PROFILED_STEPS * 1e3 for name, t in p.timers.items()
    }
    record["profile"] = _profile_steps(p, KW_PROFILED_STEPS, "kreidenweis")
    if record["pH_launches_per_step"] != 2 * settings.n_substep:
        raise AssertionError(f"phase 43: pH kernel launches a step: {record}")
    if record["profile"]["kernels_per_step"] > KW_KERNELS_PER_STEP_MAX:
        raise AssertionError(f"phase 43: kernels a step: {record['profile']}")
    record["pH_solve_forms"] = _pH_solve_forms(p, kept_pH[0][1])
    if _nonfinite_chemistry(p):
        raise AssertionError("phase 43: not finite after the profiled steps")
    print(f"phase 43: in cloud from t = {window} s: K3 on one solve against"
          f" its twin {record['k3_vs_twin']}, timed {record['k3_on_solve']};"
          f" pH kernel launches a step {record['pH_launches_per_step']!r};"
          f" ms a step by dynamic"
          f" {record['ms_per_dynamic']}; profiled {record['profile']}; the"
          f" pH solve's three forms {record['pH_solve_forms']} [{gpu}]")
    return record


def _kreidenweis_float32_vs_float64(gpu, n_sd=KW_F32_N, window=KW_F32_WINDOW):
    """phase 43b: the phase-43 settings at ``n_sd`` on the card (float32)
    and on the CPU (float64) from the same initial attributes over the
    first ``window`` seconds; the largest differences of the series: pH
    (absolute, where both are defined), gas S(IV) and aqueous S(VI)
    (relative), liquid water (relative, where it exceeds 1e-5 kg/kg).
    Held to ``KW_F32_BOUNDS``: a miss is printed as such, for ROADMAP queue
    3, and does not fail the script; a non-finite series does"""
    import numpy as np

    from pysdm_tpu_torch.backends import CPU, GPU
    from pysdm_tpu_torch.models import kreidenweis_et_al_2003 as kw
    from pysdm_tpu_torch.ops.cuda import chemistry as ph

    runs, walls, ph_launches = {}, {}, {}
    for name, backend in (("card", GPU), ("cpu_float64", CPU)):
        sim = kw.Simulation(kreidenweis_settings(n_sd, window),
                            backend_class=backend)
        ph.equilibrate_H.launches = 0
        t0 = time.perf_counter()
        runs[name] = {k: np.asarray(v) for k, v in sim.run().items()}
        walls[name] = (time.perf_counter() - t0) / sim.settings.nt * 1e3
        ph_launches[name] = ph.equilibrate_H.launches
        if _nonfinite_chemistry(sim.particulator):
            raise AssertionError(f"phase 43b: {name}: not finite")
    card, ref = runs["card"], runs["cpu_float64"]
    # the mean pH is defined once a drop is above 0.5 um: a drop may cross
    # it an output apart in the two runs
    defined = np.isfinite(ref["pH"]) & np.isfinite(card["pH"])
    cloud = ref["liquid water mixing ratio"] > 1e-5
    diffs = {
        "pH": float(np.abs(card["pH"] - ref["pH"])[defined].max()),
        "gas_S_IV": float(np.abs(card["gas_S_IV"] / ref["gas_S_IV"] - 1).max()),
        "aq_S_VI": float(np.abs(card["aq_S_VI"] / ref["aq_S_VI"] - 1).max()),
        "liquid water mixing ratio": float(np.abs(
            card["liquid water mixing ratio"][cloud]
            / ref["liquid water mixing ratio"][cloud] - 1
        ).max()),
    }
    within = {k: diffs[k] <= bound for k, bound in KW_F32_BOUNDS.items()}
    if ph_launches["card"] < 10 * sim.settings.nt or ph_launches["cpu_float64"]:
        raise AssertionError(f"phase 43b: pH kernel launches {ph_launches}")
    record = {"max_diff": diffs, "within_bounds": within,
              "ms_per_step": walls, "pH_launches": ph_launches,
              "outputs_with_pH": int(defined.sum()),
              "outputs_with_pH_in_one_run_only": int(
                  (np.isfinite(ref["pH"]) != np.isfinite(card["pH"])).sum()
              ),
              "outputs_in_cloud": int(cloud.sum())}
    print(f"phase 43b: Kreidenweis at {n_sd}, {window} s, float32 on the card"
          f" against float64 on the CPU from the same attributes: {record};"
          f" bounds {KW_F32_BOUNDS} [{gpu}]")
    return record


def _jaruga_on_card(gpu, n_sd=JP_N):
    """phase 44: ``jaruga_and_pawlowska_2018.run_convergence_point`` with
    the default backend at ``n_sd``, dt = 2 s, one substep and 50 s
    outputs, the whole ascent: the JAX test's bounds, K3 launches = solves,
    K4's launches counted, the four numbers beside the paper's"""
    import numpy as np

    from pysdm_tpu_torch.models import jaruga_and_pawlowska_2018 as jp
    from pysdm_tpu_torch.models import kreidenweis_et_al_2003 as kw
    from pysdm_tpu_torch.ops.cuda import chemistry as ph_cuda
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    k3.masses_new.launches = scan.cumsum.launches = 0
    ph_cuda.equilibrate_H.launches = 0
    with _capturing_builder(kw) as built:
        t0 = time.perf_counter()
        s_max, n_c, ph, sulfate_ppt = jp.run_convergence_point(
            n_sd, dt=2.0, n_substep=1, output_interval=50.0
        )
        wall = time.perf_counter() - t0
    (p, _), = built
    solver = p.dynamics["Condensation"].solver
    steps = p.n_steps
    record = {
        "S_max_percent": float(s_max), "n_c_per_cm3": float(n_c),
        "pH": float(ph), "sulfate_ppt": float(sulfate_ppt),
        "k3_launches": k3.masses_new.launches,
        "k4_launches": scan.cumsum.launches,
        "pH_launches": ph_cuda.equilibrate_H.launches,
        "solves": solver.substep_solves, "steps": steps,
        "ms_per_step_with_build_and_reads": wall / steps * 1e3,
        "solver_reads_per_step": solver.host_reads / steps,
        "paper": JP_PAPER,
    }
    checks = {
        "device": p.device.type == "cuda",
        "0.1 < S_max < 1.0 %": 0.1 < s_max < 1.0,
        "4 < pH < 6": 4.0 < ph < 6.0,
        "sulfate > 0": sulfate_ppt > 0.0,
        "K3 launches = solves": record["k3_launches"] == record["solves"] > 0,
        "pH kernel: two launches a step or more": record["pH_launches"] >= 2 * steps,
        "finite": not _nonfinite_chemistry(p) and np.isfinite(n_c),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 44: {failed}: {record}")
    print(f"phase 44: Jaruga & Pawlowska 2018's convergence point at {n_sd}"
          f" super-droplets, dt = 2 s, one substep, {steps} steps on the"
          f" card: {record} [{gpu}]")
    return record


def _isotopes_on_card(gpu):
    """phase 45: every function of every isotope variant on float32 CUDA
    tensors against float64 NumPy on the same (float32-rounded) inputs,
    the error over the sample's largest float64 value within
    ``ISOTOPE_F32_BOUND``; Rozanski & Sonntag's one-drop parcel through
    ``run_parcel`` with the default backend over its first ``ROZANSKI_Z``
    of ascent, K3 launches = solves, K4's launches counted, its profiles
    against a float64 CPU run; K3 held against its twin on the last kept
    one-drop solve (every ``ROZANSKI_KEEP_EVERY``-th), in cloud"""
    import inspect

    import numpy as np
    import torch

    from pysdm_tpu_torch import Formulae
    from pysdm_tpu_torch.backends import CPU
    from pysdm_tpu_torch.models import rozanski_and_sonntag_1982 as rs
    from pysdm_tpu_torch.ops.condensation import thermo
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan
    from pysdm_tpu_torch.physics import isotopes

    args = {k: np.asarray(v, np.float32).astype(np.float64)
            for k, v in isotope_arguments(2**16).items()}
    errors = {}
    t0 = time.perf_counter()
    for family, table in ISOTOPE_FAMILIES.items():
        for variant, cls in getattr(isotopes, table).items():
            formulae = Formulae(**{family: variant}, constants={
                "BOLIN_ISOTOPE_TIMESCALE_COEFF_C1": 1.63,
            })
            bound = getattr(formulae, family)
            for name in (n for n in dir(cls) if not n.startswith("_")):
                params = list(inspect.signature(getattr(cls, name))
                              .parameters.values())[1:]

                def call(wrap):
                    return getattr(bound, name)(
                        *[wrap(args[q.name]) for q in params
                          if q.kind is not q.KEYWORD_ONLY],
                        **{q.name: wrap(args[q.name]) for q in params
                           if q.kind is q.KEYWORD_ONLY},
                    )

                want = np.broadcast_to(call(lambda x: x), (2**16,))
                got = call(lambda x: torch.as_tensor(
                    x, dtype=torch.float32, device="cuda"))
                if isinstance(got, torch.Tensor):
                    if got.device.type != "cuda" or got.dtype != torch.float32:
                        raise AssertionError(f"phase 45: {variant}.{name}: {got.dtype}")
                    got = got.double().cpu().numpy()
                err = float(np.abs(got - want).max() / np.abs(want).max())
                errors[f"{variant}.{name}"] = err
    isotope_ms = (time.perf_counter() - t0) * 1e3
    worst = max(errors, key=errors.get)
    if not (all(np.isfinite(list(errors.values())))
            and errors[worst] <= ISOTOPE_F32_BOUND):
        raise AssertionError(f"phase 45: {worst} {errors[worst]}: {errors}")
    print(f"phase 45: {len(errors)} isotope formulae (every variant's every"
          f" function) on 2^16 float32 CUDA values against float64: the"
          f" largest error over the sample's scale {errors[worst]!r}"
          f" ({worst}), bound {ISOTOPE_F32_BOUND}, {isotope_ms!r} ms in all"
          f" [{gpu}]")

    profiles, kept = {}, {}
    record = {"isotope_formulae": len(errors), "isotope_max_err": errors[worst]}
    for name, kwargs in (("card", {}), ("cpu_float64", {"backend_class": CPU})):
        settings = rs.Settings(z_range=ROZANSKI_Z)
        scan.cumsum.launches = 0
        with _capturing_builder(rs) as built, _keeping_calls(
            k3, "masses_new", lambda i: i % ROZANSKI_KEEP_EVERY == 0
        ) as kept[name]:
            t0 = time.perf_counter()
            profiles[name] = rs.run_parcel(settings, **kwargs)
            wall = time.perf_counter() - t0
            launches = k3.masses_new.launches
        (p, _), = built
        solver = p.dynamics["Condensation"].solver
        record[name] = {
            "steps": p.n_steps, "solves": solver.substep_solves,
            "k3_launches": launches, "k4_launches": scan.cumsum.launches,
            "ms_per_step": wall / p.n_steps * 1e3,
            "solver_reads_per_step": solver.host_reads / p.n_steps,
            "device": p.device.type,
        }
    card = record["card"]
    if not (card["device"] == "cuda" and card["k3_launches"] == card["solves"] > 0):
        raise AssertionError(f"phase 45: Rozanski on the card: {record}")
    record["profile_max_rel_diff"] = {
        k: float(np.abs(profiles["card"][k] / profiles["cpu_float64"][k] - 1).max())
        for k in ("T", "RH", "qv")
    }
    rh = profiles["card"]["RH"]
    if not (rh.max() > 0.99 and np.isfinite(rh).all()
            and record["profile_max_rel_diff"]["T"] < 1e-4):
        raise AssertionError(f"phase 45: Rozanski profiles: {record}")
    # K3 on the one drop at the shape the parcel gives it: the last kept
    # solve, in a level past cloud base
    (formulae, _, *rows), _ = kept["card"][-1]
    thd, qv, rhod, _, _, rho_air, mu_air = rows[5:]
    solve_rh = float(thermo(formulae, thd, qv, rhod, rho_air, mu_air)[2].max())
    if not solve_rh > 0.99:
        raise AssertionError(f"phase 45: the kept solve is not in cloud: RH {solve_rh}")
    record["k3_vs_twin"] = {
        "solve": ROZANSKI_KEEP_EVERY * (len(kept["card"]) - 1), "RH": solve_rh,
        **k3_on_kept_solve(kept["card"][-1], "phase 45"),
    }
    print(f"phase 45: Rozanski & Sonntag 1982's parcel, one drop, the first"
          f" {ROZANSKI_Z} m (cloud base at the third of {card['steps']}"
          f" levels), card against float64 CPU: {record} [{gpu}]")
    return record



# --- phases 46-49: exporters and utils --------------------------------------
RESUME_FIRST = 5
RESUME_THEN = 10
# of RESUME_FIRST, the steps with collisions and sedimentation off
RESUME_SPIN_UP_STEPS = 2
EXPORT_SD_PER_CELL = 2**8
PROFILED_STEPS = 3
SCIPY_PARCEL_N = 32
SCIPY_PARCEL_STEPS = 200
# ``TestScipyOdeSolver``'s bounds, relative
SCIPY_BOUNDS = {"T": 1e-4, "qv": 5e-3, "liquid": 2e-2}
PYRCEL_TEST_PER_MODE = 16
# K2's, K3's and K4's kernels, as the profiler's trace names them
TRACED_KERNELS = {
    "coalesce_adjacent": "coalesce_adjacent_kernel",
    "masses_new": "masses_new_kernel",
    "cumsum": "scan_kernel",
}
UTILS_DIR = "build/utils"


def state_leaves(p):
    """every leaf of ``p``'s sim-state by path, the host scalars,
    ``n_steps`` and the states of its two generators"""
    import dataclasses

    sim = p.sim_state
    out = {
        f"particles/{f.name}": getattr(sim["particles"], f.name)
        for f in dataclasses.fields(sim["particles"])
    }
    for group in ("env", "counters", "flags", "u01", "host"):
        for name, value in sim.get(group, {}).items():
            out[f"{group}/{name}"] = value
    out["n_steps"] = p.n_steps
    out["generators/rng"] = p.rng.get_state()
    out["generators/device_rng"] = p.device_rng.get_state()
    return out


def state_differences(p1, p2):
    """the paths at which two particulators' ``state_leaves`` differ: a
    tensor in dtype, device or any value (``torch.equal``), anything else
    in type or value"""
    import torch

    a, b = state_leaves(p1), state_leaves(p2)
    differ = sorted(set(a) ^ set(b))
    for key in sorted(a.keys() & b.keys()):
        x, y = a[key], b[key]
        if torch.is_tensor(x):
            same = (torch.is_tensor(y) and x.dtype == y.dtype
                    and x.device == y.device and torch.equal(x, y))
        else:
            same = type(x) is type(y) and x == y
        if not same:
            differ.append(key)
    return differ


def file_differences(p, path):
    """the paths at which ``p``'s leaves differ from those ``save_npz``
    wrote to ``path``, in dtype or value"""
    import numpy as np
    import torch

    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    differ = []
    for key, leaf in state_leaves(p).items():
        # the step count and the clock are in the meta entry; the row
        # names are configuration
        if key == "n_steps" or key.startswith("host/") or isinstance(leaf, tuple):
            continue
        if key not in saved:
            if torch.is_tensor(leaf) and leaf.numel() == 0:
                continue
            differ.append(key)
            continue
        value = leaf.cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        if value.dtype != saved[key].dtype or not np.array_equal(value, saved[key]):
            differ.append(key)
    return differ


def _kernel_wrappers():
    """K1's, K2's, K3's and K4's wrappers, by name"""
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    return {
        "coalesce_mirror": kern.coalesce_mirror,
        "coalesce_adjacent": kern.coalesce_adjacent,
        "masses_new": k3.masses_new,
        "cumsum": scan.cumsum,
    }


def _zero_launch_counts():
    for wrapper in _kernel_wrappers().values():
        wrapper.launches = 0


def _launch_counts():
    return {name: w.launches for name, w in _kernel_wrappers().items()}


def _counted_steps(p, steps, between=None, first=None):
    """``steps`` steps of ``p`` one at a time, each with the launch counts of
    K1, K2, K3 and K4 set to 0 just before it and read just after, summed
    over the steps: ``between(p)``, called after each step, counts
    nothing. ``first``, a context manager factory, wraps the first step.
    Returns (the launches, what ``first`` yielded)"""
    totals = dict.fromkeys(_launch_counts(), 0)
    held = None
    for i in range(steps):
        ctx = first() if first is not None and i == 0 else contextlib.nullcontext()
        _zero_launch_counts()
        with ctx as value:
            p.run(1)
        for name, count in _launch_counts().items():
            totals[name] += count
        if i == 0:
            held = value
        if between is not None:
            between(p)
    p.block_until_ready()
    return totals, held


def _timed(call, *args):
    t0 = time.perf_counter()
    out = call(*args)
    return out, time.perf_counter() - t0


def _resume_box(gpu, directory):
    """phase 46, config #1's box at 2^20 (Golovin, non-adaptive): run A takes
    ``RESUME_FIRST`` steps, ``save_npz`` and ``RESUME_THEN`` more; run B,
    built the same way, ``restore_npz`` and ``RESUME_THEN`` steps. Every
    leaf, ``n_steps`` and both generator states equal, K1's launches equal
    over the two stretches; B's first K1 substep against its twin"""
    import os

    from pysdm_tpu_torch.dynamics.collisions import collision
    from pysdm_tpu_torch.utils import checkpoint

    path = os.path.join(directory, "box.npz")
    a = build_box(N_MAIN, 1, False)
    a.run(RESUME_FIRST)
    a.block_until_ready()
    _, save_s = _timed(checkpoint.save_npz, a, path)
    launches_a, _ = _counted_steps(a, RESUME_THEN)
    b = build_box(N_MAIN, 1, False)
    _, restore_s = _timed(checkpoint.restore_npz, b, path)
    if b.n_steps != RESUME_FIRST:
        raise AssertionError(f"phase 46: box restored at step {b.n_steps}")
    launches_b, kept = _counted_steps(
        b, RESUME_THEN,
        first=lambda: _keeping_calls(
            collision, "coalesce_mirror", lambda i: i == 0, limit=1
        ),
    )
    differ = state_differences(a, b)
    if differ:
        raise AssertionError(f"phase 46: the resumed box differs at {differ}")
    if not launches_a["coalesce_mirror"] == launches_b["coalesce_mirror"] == RESUME_THEN:
        raise AssertionError(f"phase 46: box launches {launches_a}, {launches_b}")
    seen = k1_on_kept_substep(kept[0][0], "phase 46 box")
    size = os.path.getsize(path)
    print(f"phase 46: box n_sd={N_MAIN}: {RESUME_FIRST} steps, save_npz"
          f" ({size} bytes, {save_s!r} s), {RESUME_THEN} more; a new build,"
          f" restore_npz ({restore_s!r} s), {RESUME_THEN} steps: every leaf,"
          f" n_steps and both generator states equal; K1 launches"
          f" {launches_a['coalesce_mirror']} and {launches_b['coalesce_mirror']};"
          f" K1 on the first resumed substep against its twin (slots changed,"
          f" rows max abs err) {seen} [{gpu}]")
    return {
        "launches": launches_b["coalesce_mirror"],
        "max_abs_err": seen["as drawn"][1],
        "bytes": size, "save_s": save_s, "restore_s": restore_s,
    }


def resume_products():
    """the 2D products phase 47 captures and writes"""
    import numpy as np

    from pysdm_tpu_torch.products import (
        AmbientRelativeHumidity,
        ParticleConcentration,
        WaterMixingRatio,
    )

    return (
        AmbientRelativeHumidity(name="RH"),
        WaterMixingRatio(name="qc", radius_range=(0.5e-6, 25e-6)),
        ParticleConcentration(name="n_drizzle", radius_range=(25e-6, np.inf)),
    )


def _resume_warm_rain(gpu, directory):
    """phase 46, config #5 at full width through ``make_simulation``: run A
    takes ``RESUME_SPIN_UP_STEPS`` steps of spin-up (collisions and
    sedimentation off), then with both on up to ``RESUME_FIRST``,
    ``save_npz`` and ``save_dcp``, and ``RESUME_THEN`` more; run B, built
    the same way (its spin-up flags on until the restore), ``restore_npz``
    and ``RESUME_THEN`` steps, its products captured after each (phase
    47) and its first step's K2 substep, K3 solve and K4 scans held
    against their twins. Every leaf, ``n_steps`` and both generator states
    equal, K2's, K3's and K4's launches equal. Then ``restore_dcp`` into A:
    every leaf as ``save_npz`` wrote it. Returns (the record, B, the
    captured products, their times)"""
    import os
    import shutil

    from pysdm_tpu_torch.utils import checkpoint

    def build():
        _, p, spin_up = warm_rain(
            None, WARM_RAIN_GRID, WARM_RAIN_SD_PER_CELL,
            products=resume_products(),
        )
        return p, spin_up

    npz = os.path.join(directory, "warm_rain.npz")
    dcp_dir = os.path.join(directory, "warm_rain_dcp")
    shutil.rmtree(dcp_dir, ignore_errors=True)
    (a, spin_up), build_s = _timed(build)
    a.run(RESUME_SPIN_UP_STEPS)
    spin_up.finish()
    a.run(RESUME_FIRST - RESUME_SPIN_UP_STEPS)
    a.block_until_ready()
    _, save_s = _timed(checkpoint.save_npz, a, npz)
    _, dcp_save_s = _timed(checkpoint.save_dcp, a, dcp_dir)
    launches_a, _ = _counted_steps(a, RESUME_THEN)
    b, _ = build()
    _, restore_s = _timed(checkpoint.restore_npz, b, npz)
    if not (b.n_steps == RESUME_FIRST and b.sim_state["flags"]["collision_enable"]
            and b.sim_state["flags"]["sedimentation_enable"]):
        raise AssertionError(f"phase 46: warm rain restored as {b.sim_state['flags']}")
    output = {name: [] for name in b.products}
    times = []

    def capture(p):
        # each a field on the (x, z) grid
        for name, product in p.products.items():
            output[name].append(product.get().reshape(p.mesh.grid))
        times.append(p.n_steps * p.dt)

    launches_b, captured = _counted_steps(
        b, RESUME_THEN, between=capture, first=_capturing_kernels
    )
    differ = state_differences(a, b)
    if differ:
        raise AssertionError(f"phase 46: the resumed warm rain differs at {differ}")
    for name in ("coalesce_adjacent", "masses_new", "cumsum"):
        if not launches_a[name] == launches_b[name] > 0:
            raise AssertionError(f"phase 46: {name}: {launches_a}, {launches_b}")
    errors = _captured_kernels_vs_twins(
        captured, True, gpu, "phase 46", what="resumed warm-rain"
    )
    _, dcp_restore_s = _timed(checkpoint.restore_dcp, a, dcp_dir)
    differ = file_differences(a, npz)
    if differ or a.n_steps != RESUME_FIRST:
        raise AssertionError(f"phase 46: restore_dcp differs at {differ}")
    size = os.path.getsize(npz)
    dcp_size = sum(
        os.path.getsize(os.path.join(dcp_dir, f)) for f in os.listdir(dcp_dir)
    )
    print(f"phase 46: warm rain {WARM_RAIN_GRID} x {WARM_RAIN_SD_PER_CELL}"
          f" ({b.n_sd} super-droplets; built in {build_s!r} s):"
          f" {RESUME_SPIN_UP_STEPS} spin-up steps, {RESUME_FIRST - RESUME_SPIN_UP_STEPS}"
          f" with collisions and sedimentation, save_npz ({size} bytes,"
          f" {save_s!r} s), {RESUME_THEN} more; a new build, restore_npz"
          f" ({restore_s!r} s), {RESUME_THEN} steps: every leaf, n_steps and"
          f" both generator states equal; launches A {launches_a}, B"
          f" {launches_b}; save_dcp ({dcp_size} bytes, {dcp_save_s!r} s),"
          f" restore_dcp ({dcp_restore_s!r} s): every leaf as save_npz wrote"
          f" it; coalescence rate over B"
          f" {float(b.get_counter('coalescence_rate').sum())!r} [{gpu}]")
    record = {
        "launches": {k: launches_b[k] for k in ("coalesce_adjacent", "masses_new", "cumsum")},
        "max_abs_err": errors,
        "npz": {"bytes": size, "save_s": save_s, "restore_s": restore_s},
        "dcp": {"bytes": dcp_size, "save_s": dcp_save_s, "restore_s": dcp_restore_s},
        "build_s": build_s,
    }
    return record, b, output, times


def _vtk_lines(path):
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()


def _exporters_on_card(gpu, p, output, times, directory):
    """phase 47: the products captured over phase 46's resumed steps
    written with ``NetCDFExporter`` and read back equal to the float32
    arrays; ``VTKExporter.export_products`` on the full-width state (625
    cells); ``export_attributes`` on a 25 x 25 x 2^8 warm rain (every
    point inside the domain). Returns the seconds of each"""
    import os

    import numpy as np
    from scipy.io import netcdf_file

    from pysdm_tpu_torch.exporters import NetCDFExporter, VTKExporter

    nc = os.path.join(directory, "warm_rain.nc")
    _, nc_s = _timed(NetCDFExporter(
        filename=nc, particulator=p,
        settings_attrs={"n_sd_per_gridbox": WARM_RAIN_SD_PER_CELL},
    ).run, output, times)
    with netcdf_file(nc, "r", mmap=False) as f:
        for name, series in output.items():
            got = np.asarray(f.variables[name.replace(" ", "_")][:])
            want = np.asarray(series, dtype=np.float32)
            if got.shape != (RESUME_THEN, *WARM_RAIN_GRID) or not np.array_equal(got, want):
                raise AssertionError(f"phase 47: {name} read back {got.shape}")
        written_times = np.asarray(f.variables["T"][:])
    vtk_dir = os.path.join(directory, "vtk")
    os.makedirs(vtk_dir, exist_ok=True)
    exporter = VTKExporter(path=vtk_dir)
    _, products_s = _timed(exporter.export_products, p)
    (products_file,) = exporter.exported_times["products"]
    lines = _vtk_lines(products_file)
    n_cell = WARM_RAIN_GRID[0] * WARM_RAIN_GRID[1]
    scalars = [line for line in lines if line.startswith("SCALARS")]
    if f"POINT_DATA {n_cell}" not in lines or len(lines) != 8 + len(scalars) * (n_cell + 2):
        raise AssertionError(f"phase 47: {products_file}: {len(lines)} lines")
    (_, small, spin_up), small_build_s = _timed(
        warm_rain, None, WARM_RAIN_GRID, EXPORT_SD_PER_CELL
    )
    spin_up.finish()
    small.run(2)
    small.block_until_ready()
    _, attributes_s = _timed(exporter.export_attributes, small)
    (attributes_file,) = exporter.exported_times["particles"]
    lines = _vtk_lines(attributes_file)
    n = int((small.attributes["multiplicity"] > 0).sum())
    xyz = np.loadtxt(lines[5:5 + n])
    if (lines[4] != f"POINTS {n} float" or len(lines) != 7 + n + 3 * (n + 2)
            or not (0 <= xyz[:, (0, 2)]).all() or not (xyz[:, (0, 2)] <= 1500).all()
            or (xyz[:, 1] != 0).any()):
        raise AssertionError(f"phase 47: {attributes_file}: {len(lines)} lines")
    print(f"phase 47: NetCDFExporter of {len(output)} products x {RESUME_THEN}"
          f" steps on the {WARM_RAIN_GRID} grid ({os.path.getsize(nc)} bytes,"
          f" {nc_s!r} s), read back equal to the float32 arrays, times"
          f" {float(written_times[0])!r}-{float(written_times[-1])!r} s; VTKExporter"
          f" export_products, {len(scalars)} fields of {n_cell} cells:"
          f" {products_s!r} s; export_attributes of {n} drops (3 attributes,"
          f" {WARM_RAIN_GRID} x {EXPORT_SD_PER_CELL}, built in {small_build_s!r} s):"
          f" {attributes_s!r} s, {os.path.getsize(attributes_file)} bytes [{gpu}]")
    return {"netcdf_s": nc_s, "export_products_s": products_s,
            "export_attributes_s": attributes_s, "export_attributes_drops": n}


def _scipy_pair(build, steps):
    """``build(scipy_solver)`` -> (particulator, run), run with K3 and with
    the SciPy host step: each side's K3 launches, solves, ms/step, T, qv
    and liquid water (float64 sums), and the relative differences"""
    import numpy as np

    sides = {}
    for name, scipy_solver in (("k3", False), ("scipy", True)):
        p, run = build(scipy_solver)
        solver = p.dynamics["Condensation"].solver
        solves0 = solver.substep_solves
        _zero_launch_counts()
        t0 = time.perf_counter()
        run()
        p.block_until_ready()
        wall = time.perf_counter() - t0
        mult = p.attributes["multiplicity"].astype(float)
        sides[name] = {
            "launches": _launch_counts()["masses_new"],
            "solves": solver.substep_solves - solves0,
            "ms_per_step": wall / steps * 1e3,
            "T": float(p.get_env("T")[0]),
            "qv": float(p.get_env("qv")[0]),
            "liquid": float((mult * p.attributes["water mass"]).sum()),
            "dtype": str(p.particles.extensive.dtype),
            "device": p.particles.extensive.device.type,
        }
    got, want = sides["scipy"], sides["k3"]
    diff = {key: abs(got[key] - want[key]) / abs(want[key]) for key in SCIPY_BOUNDS}
    if not (want["launches"] == want["solves"] > 0 and got["launches"] == 0
            and got["device"] == want["device"]
            and got["dtype"] == want["dtype"]
            and np.isfinite(list(diff.values())).all()):
        raise AssertionError(f"phase 48: {sides}")
    failed = [key for key, bound in SCIPY_BOUNDS.items() if not diff[key] <= bound]
    if failed:
        raise AssertionError(f"phase 48: {failed} past {SCIPY_BOUNDS}: {diff}")
    return {**sides, "rel_diff": diff}


def _scipy_solver_on_card(gpu):
    """phase 48: the JAX test's parcel (32 drops, kappa = 0.5, w = 2 m/s,
    200 steps) on the card with K3 and with ``patch_particulator``'s LSODA
    host step, then ``pyrcel.Simulation`` at ``TestPyrcel``'s 16 + 16 both
    ways: T, qv and liquid water within ``SCIPY_BOUNDS``; the K3 side's
    launches = solves, none on the SciPy side"""
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.models import pyrcel
    from pysdm_tpu_torch.utils.scipy_ode_condensation_solver import (
        patch_particulator,
    )

    def parcel(scipy_solver):
        p = build_parcel(SCIPY_PARCEL_N, GPU, True)
        if scipy_solver:
            patch_particulator(p)
        return p, lambda: p.run(SCIPY_PARCEL_STEPS)

    settings = pyrcel_settings(PYRCEL_TEST_PER_MODE)

    def pyrcel_sim(scipy_solver):
        sim = pyrcel.Simulation(settings, scipy_solver=scipy_solver)
        return sim.particulator, sim.run

    record = {
        "parcel": _scipy_pair(parcel, SCIPY_PARCEL_STEPS),
        "pyrcel": _scipy_pair(pyrcel_sim, settings.nt),
    }
    for name, r in record.items():
        print(f"phase 48: {name}: K3 {r['k3']['launches']} launches ="
              f" solves, {r['k3']['ms_per_step']!r} ms/step; LSODA on the"
              f" host {r['scipy']['ms_per_step']!r} ms/step, no launch; relative"
              f" differences {r['rel_diff']} within {SCIPY_BOUNDS} [{gpu}]")
    return record


def _profile_on_card(gpu, p, directory):
    """phase 49: ``profile_run`` over ``PROFILED_STEPS`` full-width
    warm-rain steps into a trace: every dynamic's time > 0, the trace's
    kernels K2's, K3's and K4's and its scopes every dynamic's"""
    import os
    import shutil

    from pysdm_tpu_torch.utils.profiling import profile_run

    logdir = os.path.join(directory, "profile")
    shutil.rmtree(logdir, ignore_errors=True)
    steps0 = p.n_steps
    times, wall = _timed(profile_run, p, PROFILED_STEPS, logdir)
    (trace,) = os.listdir(logdir)
    with open(os.path.join(logdir, trace), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    scopes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    traced = {
        name: sum(kernel in k for k in kernels)
        for name, kernel in TRACED_KERNELS.items()
    }
    if not (all(v > 0 for v in times.values()) and all(traced.values())
            and set(times) <= scopes and p.n_steps == steps0 + PROFILED_STEPS):
        raise AssertionError(f"phase 49: {times}, {traced}, {sorted(scopes)}")
    print(f"phase 49: profile_run over {PROFILED_STEPS} full-width warm-rain"
          f" steps ({wall!r} s): seconds by dynamic {times}; the trace"
          f" ({os.path.getsize(os.path.join(logdir, trace))} bytes) holds"
          f" {len(kernels)} kernels, of them K2, K3, K4 {traced} [{gpu}]")
    return {"seconds": times, "traced_launches": traced, "wall_s": wall}


def _exporters_and_utils(gpu):
    """phases 46-49; returns their records and seconds"""
    import os

    os.makedirs(UTILS_DIR, exist_ok=True)
    seconds, record = {}, {}
    t0 = time.perf_counter()
    record["box"] = _resume_box(gpu, UTILS_DIR)
    record["warm_rain"], p, output, times = _resume_warm_rain(gpu, UTILS_DIR)
    seconds["46"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["exporters"] = _exporters_on_card(gpu, p, output, times, UTILS_DIR)
    seconds["47"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["scipy"] = _scipy_solver_on_card(gpu)
    seconds["48"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["profile"] = _profile_on_card(gpu, p, UTILS_DIR)
    seconds["49"] = time.perf_counter() - t0
    print(f"phases 46-49: seconds {seconds}, together"
          f" {sum(seconds.values())!r} s [{gpu}]")
    return {**record, "seconds": seconds}


# --- phase 50: the decomposed warm rain over torch.distributed ------------
DIST_RANKS = 5
DIST_STEPS = 10
DIST_SPIN_UP_STEPS = 2
# B against A (PERF.md): 99.9% of the rows within the JAX package's float64
# bounds of its shard invariance (positions in grid units, water masses in
# kg), every row within ``DIST_MAX_BOUNDS``: in float32 the per-cell sums
# (prefix differences over 625 cells in A, 125 in B) move a cell's RH by
# ~1e-6, and a drop at its critical radius activates in one run and not in
# the other (PR 15's first run: one drop 1.1e-17 kg in A, 2.9e-13 in B,
# 2.2e-3 grid units lower); the fields (thd, qv, RH) within 1e-4 relative
DIST_BOUNDS = {"position": 1e-3, "water_mass": 1e-13, "field_rel": 1e-4}
DIST_QUANTILE = 0.999
DIST_MAX_BOUNDS = {"position": 1e-2, "water_mass": 1e-12}
# B against A after each of the DIST_STEPS steps: bounds on the fields'
# largest relative deviation (the largest of thd, qv and RH), twice the
# value measured after that step on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6, PR 16: RH 6.1e-6, 9.4e-4, 6.1e-4, 9.1e-5, then 1.6e-5 to
# 2.8e-5), rounded up to one digit. The series was bit-stable from run to
# run, so a step past its bound is a change in the physics, not noise
DIST_FIELD_STEP_BOUNDS = (2e-5, 2e-3, 2e-3, 2e-4, 6e-5, 6e-5, 6e-5, 6e-5,
                          6e-5, 6e-5)
DIST_TIMEOUT = 300.0
# D: the CPU test's overflow case, its 16 x 8 grid narrowed to one that
# DIST_RANKS slabs divide
DIST_OVERFLOW_GRID = (15, 8)
DIST_OVERFLOW_STEPS = 6
DIST_OVERFLOW_CAPACITY = 4


def dist_settings():
    """config #5 at full width from a haze start, as phase 10's"""
    from pysdm_tpu_torch.parallel.verification import warm_rain_settings

    return warm_rain_settings(
        seed=44, grid=WARM_RAIN_GRID, n_sd_per_gridbox=WARM_RAIN_SD_PER_CELL
    )


def dist_overflow_settings():
    """phase 50 D's case: the crosswind of the CPU overflow test"""
    from pysdm_tpu_torch.parallel.verification import warm_rain_settings

    return warm_rain_settings(
        seed=29, grid=DIST_OVERFLOW_GRID, n_sd_per_gridbox=8, crosswind=True
    )


def _distributed_overflow_rank():
    """phase 50, run D, inside a rank: the overflow case on the card under
    the migration probe; returns the rank's record and its seconds"""
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.parallel import verification

    record, seconds = _timed(lambda: verification.rank_warm_rain(
        dist_overflow_settings, (DIST_OVERFLOW_STEPS,),
        dict(migration_capacity=DIST_OVERFLOW_CAPACITY), True, False, GPU,
        probe=True,
    ))
    return {**record, "seconds": seconds}


def _overflow_held(d_ranks):
    """phase 50 D's checks over every rank's records (module docstring);
    raises where one fails, returns the counts"""
    probes = [s for r in d_ranks for s in r["probe"]]
    end = d_ranks[0]["snapshots"][-1]
    counts = {
        key: sum(s[key] for s in probes)
        for key in ("stashed", "expected", "selected", "matched", "away")
    }
    counts["commits"] = len(probes)
    counts["send_dropped"] = sum(s["dropped"][0] for s in probes)
    counts["place_dropped"] = sum(s["dropped"][1] for s in probes)
    counts["counter"] = end["migration_dropped"]
    failed = [
        name for name, bad in (
            ("commits", len(probes) != DIST_RANKS * DIST_OVERFLOW_STEPS),
            ("no overflow", counts["stashed"] == 0),
            ("later rounds shipped other than the stash", any(
                not s["selected"] == s["matched"] == s["expected"]
                for s in probes)),
            ("send drops != leftovers past the rounds", any(
                s["dropped"][0] != s["stashed"] - s["expected"]
                for s in probes)),
            ("drops != counter", counts["send_dropped"]
             + counts["place_dropped"] != counts["counter"]),
            ("multiplicity", end["multiplicity_min"] < 0),
            ("water", end["water_mass_nonfinite"] != 0),
        ) if bad
    ]
    if failed:
        raise AssertionError(
            f"phase 50 D: {failed}: {counts}, end {end}, probes {probes}"
        )
    return counts


def _field_steps_deviation(b_steps, a_steps):
    """the largest relative deviation of each field of B from A's, step by
    step"""
    import numpy as np

    return [
        {f: float(np.max(np.abs(b[f] - a[f]) / np.abs(a[f]))) for f in a}
        for b, a in zip(b_steps, a_steps)
    ]


def _distributed_rain_rank(gpu):
    """phase 50, run C, inside a rank: the decomposed warm rain on the
    card, 2 spin-up steps, then ``DIST_STEPS`` with collisions and
    sedimentation on, each counted (module docstring). Raises where a check
    fails; returns the rank's record"""
    import torch
    import torch.distributed as dist

    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.parallel import DistributedSimulation2D, migration
    from pysdm_tpu_torch.parallel.halo import traffic

    rank = dist.get_rank()
    sim, build_s = _timed(
        lambda: DistributedSimulation2D(dist_settings(), backend_class=GPU)
    )
    p = sim.particulator
    for flag in ("collision_enable", "sedimentation_enable"):
        p.set_flag(flag, False)
    start = sim.global_diagnostics()
    sim.run(DIST_SPIN_UP_STEPS)
    for flag in ("collision_enable", "sedimentation_enable"):
        p.set_flag(flag, True)
    collision = p.dynamics["Collision"]
    solver = p.dynamics["Condensation"].solver
    real_start = migration.migrate_ring_start
    in_flight = []

    def counting_start(**kwargs):
        arrays, inflight = real_start(**kwargs)
        in_flight.append(inflight["shipped"] + inflight["stashed"])
        return arrays, inflight

    steps, captured = [], None
    with _replaced(migration, "migrate_ring_start", counting_start):
        for i in range(DIST_STEPS):
            substeps0 = collision.substeps_run
            solves0 = solver.substep_solves
            alive = (p.particles.multiplicity > 0).sum()
            first = i == 0 and rank == 0
            ctx = _capturing_kernels() if first else contextlib.nullcontext()
            torch.cuda.synchronize()
            _zero_launch_counts()
            traffic.reset()
            t0 = time.perf_counter()
            with ctx as held:
                p.run(1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = _launch_counts()
            if first:
                captured = held
            steps.append({
                "ms": ms,
                "launches": {k: counts[k] for k in TRACED_KERNELS},
                "substeps": collision.substeps_run - substeps0,
                "solves": solver.substep_solves - solves0,
                "bytes": traffic.bytes,
                "exchanges": traffic.calls,
                "alive": int(alive),
                "in_flight": int(in_flight[-1]),
            })
    end = sim.global_diagnostics()
    dropped = int(sim.get_counter("migration_dropped").sum())
    far = int(sim.get_counter("migration_far_moves").sum())
    mult_min = p.particles.multiplicity.min().reshape(1)
    dist.all_reduce(mult_min, op=dist.ReduceOp.MIN)
    crossed = torch.tensor(
        [sum(s["in_flight"] for s in steps)], device=p.device
    )
    dist.all_reduce(crossed)
    mult_min, crossed = int(mult_min), int(crossed)
    drift = (end["water_total"] - start["water_total"]) / start["water_total"]
    failed = [
        name for name, bad in (
            ("water", not abs(drift) < 1e-3),
            ("dropped", dropped != 0),
            ("far moves", far != 0),
            ("condensation", end["condensation_ok"] != 1.0),
            ("multiplicity", mult_min < 0),
            ("no slab crossed", crossed == 0),
            ("K2 != substeps", any(
                s["launches"]["coalesce_adjacent"] != s["substeps"] or
                s["substeps"] < 1 for s in steps)),
            ("K3 != solves", any(
                s["launches"]["masses_new"] != s["solves"] for s in steps)),
            ("no K3", sum(s["solves"] for s in steps) == 0),
            ("no K4", any(s["launches"]["cumsum"] == 0 for s in steps)),
        ) if bad
    ]
    if failed:
        raise AssertionError(
            f"phase 50 C, rank {rank}: {failed}: drift {drift!r}, dropped"
            f" {dropped}, far {far}, {end}, multiplicity min {mult_min},"
            f" crossed {crossed}, steps {steps}"
        )
    record = {
        "rank": rank, "backend": dist.get_backend(), "build_s": build_s,
        "steps": steps, "water_drift": drift, "crossed": crossed,
        "start": start, "end": end,
    }
    if captured is not None:
        record["max_abs_err"] = _captured_kernels_vs_twins(
            captured, True, gpu, "phase 50 C rank 0", what="decomposed warm-rain"
        )
    return record


def _held_to(b_rows, a_rows, b_fields, a_fields):
    """run B's canonical rows and fields against run A's: the
    ``DIST_QUANTILE`` quantile of the rows' differences within
    ``DIST_BOUNDS``, their largest within ``DIST_MAX_BOUNDS``, the fields'
    within ``DIST_BOUNDS``; rows whose (dry volume, multiplicity) key ties
    in float32 are matched by key only. Returns the differences (quantile
    and largest) and the count of tied rows"""
    import numpy as np

    if b_rows.shape != a_rows.shape:
        raise AssertionError(f"phase 50: alive {b_rows.shape} vs {a_rows.shape}")
    for col, name in ((0, "dry volume"), (4, "multiplicity")):
        if not np.array_equal(b_rows[:, col], a_rows[:, col]):
            raise AssertionError(f"phase 50: {name} identities differ")
    key = a_rows[:, [0, 4]]
    tied = np.zeros(len(key), dtype=bool)
    same = (key[1:] == key[:-1]).all(axis=1)
    tied[1:] |= same
    tied[:-1] |= same
    rows = ~tied
    per_row = {
        "position": np.abs(b_rows[rows, 1:3] - a_rows[rows, 1:3]).max(axis=1),
        "water_mass": np.abs(b_rows[rows, 3] - a_rows[rows, 3]),
    }
    diffs = {
        name: {"quantile": float(np.quantile(d, DIST_QUANTILE)),
               "max": float(d.max())}
        for name, d in per_row.items()
    }
    diffs["field_rel"] = max(
        float(np.max(np.abs(b_fields[f] - a_fields[f]) / np.abs(a_fields[f])))
        for f in a_fields
    )
    held = diffs["field_rel"] <= DIST_BOUNDS["field_rel"] and all(
        diffs[k]["quantile"] <= DIST_BOUNDS[k]
        and diffs[k]["max"] <= DIST_MAX_BOUNDS[k]
        for k in per_row
    )
    if not held:
        raise AssertionError(
            f"phase 50: B against A {diffs}, bounds {DIST_BOUNDS} (the"
            f" {DIST_QUANTILE} quantile), {DIST_MAX_BOUNDS} (every row)"
        )
    return diffs, int(tied.sum())


def _child_pids():
    """this process's children that have not been reaped, from /proc"""
    me, found = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # state and parent follow the command name, which may hold spaces
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            found.append(int(entry))
    return found


def _distributed_on_card(gpu):
    """phase 50 (module docstring); returns its record"""
    import numpy as np
    import torch

    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.parallel import multihost, verification

    t_phase = time.perf_counter()
    backend = multihost.backend_for(DIST_RANKS, "cuda")
    print(f"phase 50: {DIST_RANKS} ranks over {backend}"
          f" ({torch.cuda.device_count()} card(s) on this host); run A on"
          f" one rank over {multihost.backend_for(1, 'cuda')} [{gpu}]")
    warm = (functools.partial(verification.rank_warm_rain, field_steps=True), (
        dist_settings, (DIST_STEPS,), None, False, True, GPU,
    ))
    try:
        (a_run,), a_s = _timed(lambda: multihost.spawn(
            verification.rank_cases, 1, [warm],
            backend=multihost.backend_for(1, "cuda"), timeout=DIST_TIMEOUT,
        ))
        ranks, bc_s = _timed(lambda: multihost.spawn(
            verification.rank_cases, DIST_RANKS,
            [warm, (_distributed_rain_rank, (gpu,)),
             (_distributed_overflow_rank, ())],
            backend=backend, timeout=DIST_TIMEOUT,
        ))
    finally:
        # the fork server and the resource tracker, waited for
        multihost.shutdown()
    left = _child_pids()
    assert not left, f"phase 50: processes {left} outlived their spawn"
    print("phase 50: fork server and resource tracker stopped, no child"
          " process left")
    a = a_run[0]["snapshots"][-1]
    b = ranks[0][0]["snapshots"][-1]
    diffs, tied = _held_to(b["rows"], a["rows"], b["fields"], a["fields"])
    print(f"phase 50: B ({DIST_RANKS} x-slabs, {ranks[0][0]['capacity']}"
          f" slots a rank) against A (one rank) after {DIST_STEPS} steps,"
          f" collisions off: {len(a['rows'])} alive, dry-volume identities"
          f" and multiplicities equal; differences {diffs} (bounds"
          f" {DIST_BOUNDS} on the {DIST_QUANTILE} quantile, {DIST_MAX_BOUNDS}"
          f" on every row; {tied} rows of float32-tied keys matched by key"
          f" only); dropped {b['migration_dropped']}, far"
          f" {b['migration_far_moves']} [{gpu}]")
    field_steps = _field_steps_deviation(
        ranks[0][0]["field_steps"], a_run[0]["field_steps"]
    )
    for i, dev in enumerate(field_steps):
        print(f"phase 50: B against A after step {i + 1}: fields' largest"
              f" relative deviation {dev} (bound on the largest"
              f" {DIST_FIELD_STEP_BOUNDS[i]}) [{gpu}]")
    beyond = [
        (i + 1, max(dev.values()), bound)
        for i, (dev, bound) in enumerate(zip(field_steps, DIST_FIELD_STEP_BOUNDS))
        if not max(dev.values()) <= bound
    ]
    if len(field_steps) != len(DIST_FIELD_STEP_BOUNDS) or beyond:
        raise AssertionError(
            f"phase 50: B against A beyond DIST_FIELD_STEP_BOUNDS (step,"
            f" deviation, bound): {beyond}; {len(field_steps)} steps"
        )
    c = [r[1] for r in ranks]
    ms = [[s["ms"] for s in r["steps"]] for r in c]
    per_rank = {
        name: [[s["launches"][name] for s in r["steps"]] for r in c]
        for name in TRACED_KERNELS
    }
    step_bytes = [float(np.mean([s["bytes"] for s in r["steps"]])) for r in c]
    exchanges = c[0]["steps"][0]["exchanges"]
    in_flight = sum(s["in_flight"] for r in c for s in r["steps"])
    alive = sum(s["alive"] for r in c for s in r["steps"])
    for r, record in enumerate(c):
        print(f"phase 50: C rank {r}: ms/step {ms[r]}; K2, K3, K4 launches"
              f" per step {[per_rank[k][r] for k in TRACED_KERNELS]}; bytes"
              f" sent a step {step_bytes[r]!r} in {exchanges} exchanges;"
              f" build {record['build_s']!r} s")
    errs = c[0]["max_abs_err"]
    print(f"phase 50: C over {backend}, {DIST_STEPS} steps after"
          f" {DIST_SPIN_UP_STEPS} of spin-up: water drift"
          f" {c[0]['water_drift']!r}, {c[0]['crossed']} particles crossed"
          f" slabs, in flight {in_flight} of {alive} alive-steps"
          f" ({in_flight / alive!r}); mean ms/step by rank"
          f" {[float(np.mean(m)) for m in ms]} (the one-card {backend} path"
          f" staged through the host, no speed of several GPUs); rank 0's"
          f" first step against the twins {errs} [{gpu}]")
    d = [r[2] for r in ranks]
    overflow = _overflow_held(d)
    d_s = max(r["seconds"] for r in d)
    print(f"phase 50: D ({DIST_RANKS} x-slabs of {DIST_OVERFLOW_GRID},"
          f" capacity {DIST_OVERFLOW_CAPACITY}, overlap and collisions on,"
          f" {DIST_OVERFLOW_STEPS} steps over {backend}): {overflow}; every"
          f" commit's later round shipped exactly its stash, multiplicity"
          f" min {d[0]['snapshots'][-1]['multiplicity_min']}; {d_s!r} s"
          f" [{gpu}]")
    seconds = time.perf_counter() - t_phase
    print(f"phase 50: {seconds!r} s (A {a_s!r}, B, C and D {bc_s!r})")
    return {
        "backend": backend, "ranks": DIST_RANKS,
        "a_backend": multihost.backend_for(1, "cuda"),
        "b_against_a": diffs, "tied_rows": tied,
        "ms_per_step": ms, "bytes_per_step": step_bytes,
        "exchanges_per_step": exchanges,
        "in_flight": in_flight, "alive_steps": alive,
        "crossed": c[0]["crossed"], "water_drift": c[0]["water_drift"],
        "launches": {k: [sum(x) for x in v] for k, v in per_rank.items()},
        "max_abs_err": errs, "seconds": seconds,
        "b_field_steps": field_steps, "d_overflow": overflow, "d_seconds": d_s,
    }


def build_kernels(fresh=False):
    """every CUDA kernel of the port built from its source
    (``pysdm_tpu_torch/csrc``), one nvcc per source, all started together;
    with ``fresh``, the libraries of these sources and flags deleted first,
    so that each is built anew. Returns the sources' names"""
    from pysdm_tpu_torch.ops.cuda import _build
    from pysdm_tpu_torch.ops.cuda import breakup as k5
    from pysdm_tpu_torch.ops.cuda import chemistry as ph
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    sources = (
        "collision_mirror", "condensation", "scan", "collision_adjacent",
        "collision_breakup", "chemistry",
    )
    if fresh:
        for name in sources:
            _build.library_path(name)[1].unlink(missing_ok=True)
    loaders = (
        kern.library, k3.library, scan.library, kern.library_adjacent,
        k5.library, ph.library,
    )
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for future in [pool.submit(load) for load in loaders]:
            future.result()
    return sources


class PhaseClock:
    """each phase's wall time on the host clock and the total since the
    clock was made, printed as ``phase N: wall X s, total Y s`` when
    ``clock(N)`` is called at the phase's end, and kept in ``walls``"""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.walls = {}

    def __call__(self, phase, name=None):
        now = time.perf_counter()
        self.walls[phase] = now - self.last
        print(f"phase {phase}: wall {now - self.last!r} s, total"
              f" {now - self.start!r} s" + (f" ({name})" if name else ""))
        self.last = now


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from pysdm_tpu_torch.ops.cuda import _build
    from pysdm_tpu_torch.ops.cuda import breakup as k5
    from pysdm_tpu_torch.ops.cuda import collision as kern
    from pysdm_tpu_torch.ops.cuda import condensation as k3
    from pysdm_tpu_torch.ops.cuda import scan

    clock = PhaseClock()
    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" python {sys.version.split()[0]}")
    nvcc = _build.nvcc_path()
    print(f"nvcc {nvcc}: {_nvcc_version(nvcc)}")
    try:
        import triton  # noqa: F401

        print(f"triton {triton.__version__} imports")
    except ImportError as err:
        print(f"triton does not import: {err}")

    t0 = time.perf_counter()
    sources = build_kernels(fresh=True)
    print(f"phase 1: built {', '.join(sources)} in"
          f" {time.perf_counter() - t0!r} s")
    clock("0-1")

    device = torch.device("cuda")
    max_abs_err, kernel_ms, twin_ms = _kernel_vs_twin(torch, kern, device, gpu)
    clock("2")
    launches = _main_path(torch, kern, gpu)
    clock("3")
    _adaptive(kern, gpu)
    clock("4")
    k3_err, k3_times, k3_counts = _k3_vs_twin(torch, k3, device, gpu)
    clock("5")
    k3_launches, _ = _parcel_main_path(k3, gpu)
    clock("6")
    _parcel_gpu_vs_cpu(k3)
    clock("7")
    k4_err, k4_ms, k4_twin_ms, k4_n = _k4_vs_twin(torch, scan, device, gpu)
    clock("8")
    k2_err, k2_ms, k2_twin_ms, k2_bytes = _k2_vs_twin(torch, kern, device, gpu)
    clock("9")
    warm_launches, p, _ = _warm_rain_main_path(kern, k3, scan, gpu)
    k3_err = max(k3_err, _k3_on_a_warm_rain_solve(torch, p, k3, gpu))
    _percell_sums_vs_float64(p)
    clock("10")
    _warm_rain_with_twins(p, gpu)
    del p
    clock("12")
    _warm_rain_scenario_on_card(gpu)
    clock("11")
    k5_err, k5_ms, k5_twin_ms, k5_bytes, k5_ops = _k5_vs_twin(
        torch, k5, device, gpu
    )
    clock("13")
    k5_launches = _breakup_main_path(k5, gpu)
    clock("14")
    _breakup_model(k5, gpu)
    clock("15")
    column, column_err = _column_main_path(gpu)
    clock("16")
    _column_published_on_card(gpu)
    clock("17")
    geo_err, geo_ms, geo_rotated_ms, geo_bytes = _k1_geometric_vs_twin(
        torch, kern, device, gpu
    )
    clock("18")
    _shima_model(kern, gpu)
    _box_model_entry_points(kern, gpu)
    clock("19")
    berry_launches = _berry_model(kern, gpu)
    clock("20")
    bulenok_launches = _bulenok_model(k5, gpu)
    clock("21")
    dejong = _dejong_column(gpu)
    clock("22")
    from pysdm_tpu_torch.backends import GPU

    (k3_mixed_err, k3_mixed_ms, k3_mixed_liquid_ms, k3_mixed_bound,
     _) = _k3_mixed_phase(torch, k3, device, gpu)
    clock("23")
    _alpert_knopf(GPU, gpu)
    clock("24")
    _spichtinger(GPU, gpu, n_sd=SPICHTINGER_TEST_N)
    spichtinger_launches, _ = _spichtinger(GPU, gpu)
    clock("25")
    _abade(GPU, gpu, n_sd=ABADE_TEST_N)
    _abade(GPU, gpu)
    clock("26")
    _niedermeier(GPU, gpu)
    clock("27")
    _float32_ice_records(GPU, gpu)
    clock("28")
    k1a_err, k1a_times, k1a_rotated_ms, k1p = _k1a_vs_twin(
        torch, kern, device, gpu
    )
    clock("29")
    k1p_launches, k1a_launches, berry_kernels = _berry_kernels_model(kern, gpu)
    clock("30")
    straub, straub_k4 = _straub_on_card(gpu)
    clock("31")
    bieli = _bieli_on_card(gpu)
    clock("32")
    pure_breakup = _pure_breakup_handle_all(gpu)
    clock("33")
    variant_sets = _k3_variant_sets(torch, k3, device, gpu)
    clock("34")
    lowe = _lowe(gpu)
    clock("35")
    jensen_nugent = _jensen_nugent(gpu)
    clock("36")
    yang_arabas_shima = _yang_and_arabas_shima(gpu)
    clock("37")
    model_phases = {}
    for number, name, phase in (
        ("38", "mg2007_mixed_phase", _mg2007_on_card),
        ("39", "bartman_et_al_2021",
         lambda gpu: _bartman_on_card(gpu, warm_launches)),
        ("40", "activation_parcels", _activation_parcels),
        ("41", "arabas_et_al_2025", _arabas_2025_on_card),
        ("42", "seeding", _seeding_on_card),
        ("43", "kreidenweis_et_al_2003", _kreidenweis_on_card),
        ("43b", "kreidenweis_float32_vs_float64",
         _kreidenweis_float32_vs_float64),
        ("44", "jaruga_and_pawlowska_2018", _jaruga_on_card),
        ("45", "isotopes", _isotopes_on_card),
        ("46-49", "exporters_and_utils", _exporters_and_utils),
        ("50", "distributed_warm_rain", _distributed_on_card),
    ):
        model_phases[name] = phase(gpu)
        clock(number, name)
    mg2007, bartman = model_phases["mg2007_mixed_phase"], model_phases["bartman_et_al_2021"]
    parcels, seeded = model_phases["activation_parcels"], model_phases["seeding"]
    kreidenweis = model_phases["kreidenweis_et_al_2003"]
    pH_solve = kreidenweis["pH_vs_twin"]
    jaruga, isotope_record = (model_phases["jaruga_and_pawlowska_2018"],
                              model_phases["isotopes"])
    utils = model_phases["exporters_and_utils"]
    resumed = utils["warm_rain"]
    distributed = model_phases["distributed_warm_rain"]
    # K3's launches on the model path of each set (phases 35-37)
    set_launches = {
        "a_august_roche_magnus": (
            yang_arabas_shima[f"yang_{YANG_FULL_N}"]["k3_launches"]
            + yang_arabas_shima["arabas_shima"]["k3_launches"]
        ),
        "b_grabowski_2011": jensen_nugent[JN_FULL_N]["k3_launches"],
        "c_lowe_film": lowe["film_full_width"]["k3_launches"],
        "d_lowe_constant": lowe["Constant"]["k3_launches"],
    }

    # least times on the card, from this run's inputs: K1 at N_MAIN with two
    # float32 rows (mult 8 + rows 8 + volume 4 in, mult 8 + rows 8 out per
    # slot); K3 at N_PARCEL (24 B in, 5 B out per drop; its operations from
    # the minfun evaluations these drops need); K4 float32 (4 B in, 4 out)
    k1_bound = bound_ms(N_MAIN * 36)
    k3_bound = bound_ms(
        N_PARCEL * 29, k3_counts[N_PARCEL] * K3_OPS_PER_MINFUN
    )
    k4_bound = bound_ms(k4_n * 8)
    k2_bound = bound_ms(k2_bytes)
    k5_bound = bound_ms(k5_bytes, k5_ops)
    geo_bound = bound_ms(geo_bytes)
    # K1a at the main path's width (Berry 1967's 2^13) and at 2^20: per
    # slot the multiplicity and the extensive rows read and written, the
    # kernel x norm and u01 rows read
    k1a_bound = {n: bound_ms(t[2]) for n, t in k1a_times.items()}
    # K1a's Parameterized form: the state read and written, the radius,
    # fall-velocity and u01 rows read
    k1p_bound = {n: bound_ms(t[2]) for n, t in k1p["times"].items()}

    # the float64 paths' records, which launch no kernel of their own
    print(json.dumps({"paths": {
        "straub": straub, "straub_sort_k4": straub_k4, "bieli": bieli,
        "pure_breakup_handle_all": pure_breakup,
        "lowe_et_al_2019": lowe,
        "jensen_and_nugent_2017": {str(k): v for k, v in jensen_nugent.items()},
        "yang_and_arabas_shima": yang_arabas_shima,
        "mg2007_mixed_phase": mg2007,
        "bartman_et_al_2021": {str(k): v for k, v in bartman.items()},
        "activation_parcels": parcels,
        "arabas_et_al_2025": model_phases["arabas_et_al_2025"],
        "seeding": seeded,
        "kreidenweis_et_al_2003": kreidenweis,
        "kreidenweis_float32_vs_float64":
            model_phases["kreidenweis_float32_vs_float64"],
        "jaruga_and_pawlowska_2018": jaruga,
        "berry_kernels": berry_kernels,
        "isotopes": isotope_record,
        "exporters_and_utils": utils,
        "distributed_warm_rain": {
            k: v for k, v in distributed.items()
            if k not in ("launches", "max_abs_err")
        },
        "k3_parcel_vs_parent": {
            str(k): v
            for k, v in variant_sets.get("parcel_vs_parent", {}).items()
        },
        "phase_walls": clock.walls,
    }}))
    print(json.dumps({"kernels": [{
        "name": "coalesce_mirror",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_mirror.cu",
        "replaces": "pysdm_tpu/ops/pallas/collision.py:582",
        "launches": launches,
        "berry_launches": berry_launches,
        "seeding_launches": seeded["k1_launches"],
        "seeding_max_abs_err": seeded["k1_vs_twin"]["as drawn"][1],
        "resume_launches": utils["box"]["launches"],
        "resume_max_abs_err": utils["box"]["max_abs_err"],
        "max_abs_err": max_abs_err,
        "geometric_max_abs_err": geo_err,
        "ms": kernel_ms,
        "geometric_ms": geo_ms,
        "geometric_rotated_ms": geo_rotated_ms,
        "plain_ms": twin_ms,
        "bound_ms": k1_bound[0],
        "geometric_bound_ms": geo_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }, {
        "name": "masses_new",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/condensation.cu",
        "replaces": "pysdm_tpu/ops/pallas/condensation.py:299",
        "launches": k3_launches,
        "column_launches": column["masses_new"],
        "column_max_abs_err": column_err["masses_new"],
        "spichtinger_launches": spichtinger_launches,
        "mg2007_launches": mg2007["launches"]["masses_new"],
        "mg2007_max_abs_err": mg2007["k3_vs_twin"]["mass"],
        "bartman_launches": {
            str(n): r["launches"]["masses_new"] for n, r in bartman.items()
        },
        "parcel_model_launches": {
            name: r["k3_launches"] for name, r in parcels.items()
        },
        "seeding_launches": seeded["k3_launches"],
        "seeding_max_abs_err": seeded["k3_vs_twin"]["mass"],
        "kreidenweis_launches": kreidenweis["k3_launches"],
        "kreidenweis_max_abs_err": kreidenweis["k3_vs_twin"]["mass"],
        "kreidenweis_ms": kreidenweis["k3_on_solve"]["ms"],
        "kreidenweis_plain_ms": kreidenweis["k3_on_solve"]["plain_ms"],
        "kreidenweis_bound_ms": kreidenweis["k3_on_solve"]["bound_ms"],
        "jaruga_launches": jaruga["k3_launches"],
        "rozanski_launches": isotope_record["card"]["k3_launches"],
        "rozanski_max_abs_err": isotope_record["k3_vs_twin"]["mass"],
        "resume_launches": resumed["launches"]["masses_new"],
        "resume_max_abs_err": resumed["max_abs_err"]["masses_new"],
        "scipy_parcel_launches": utils["scipy"]["parcel"]["k3"]["launches"],
        "distributed_launches": distributed["launches"]["masses_new"],
        "distributed_max_abs_err": distributed["max_abs_err"]["masses_new"],
        "parcel_model_max_abs_err": {
            name: r["k3_vs_twin"]["mass"] for name, r in parcels.items()
        },
        "bartman_max_abs_err": {
            str(n): r["max_abs_err"]["masses_new"]
            for n, r in bartman.items() if "max_abs_err" in r
        },
        "max_abs_err": max(k3_err, k3_mixed_err),
        "ms": k3_times[N_PARCEL][0],
        "k3_mixed_phase_ms": k3_mixed_ms,
        "k3_mixed_phase_all_liquid_ms": k3_mixed_liquid_ms,
        "k3_mixed_phase_bound_ms": k3_mixed_bound[0],
        "plain_ms": k3_times[N_PARCEL][1],
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        "library_ms": None,
        "variant_sets": {
            name: {
                "max_err": record["max_abs_err"],
                "ms": record["ms"],
                "twin_ms": record["twin_ms"],
                "bound_ms": record["bound_ms"],
                "bound_by": record["bound_by"],
                "ms_2_20": record["ms_2_20"],
                "near_saturation_log_mass": record["near_saturation"][
                    "log-mass"
                ],
                "bound_ms_2_20": record["bound_ms_2_20"],
                "launches": set_launches.get(name),
            }
            for name, record in variant_sets.items()
            if name in K3_VARIANT_SETS
        },
    }, {
        "name": "coalesce_adjacent",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_adjacent.cu",
        "replaces": "pysdm_tpu/ops/pallas/collision.py:721",
        "launches": warm_launches["coalesce_adjacent"],
        "column_launches": column["coalesce_adjacent"],
        "dejong_column_launches": dejong["coalesce_adjacent"],
        "mg2007_launches": mg2007["launches"]["coalesce_adjacent"],
        "bartman_launches": {
            str(n): r["launches"]["coalesce_adjacent"] for n, r in bartman.items()
        },
        "column_max_abs_err": column_err["coalesce_adjacent"],
        "resume_launches": resumed["launches"]["coalesce_adjacent"],
        "resume_max_abs_err": resumed["max_abs_err"]["coalesce_adjacent"],
        "distributed_launches": distributed["launches"]["coalesce_adjacent"],
        "distributed_max_abs_err":
            distributed["max_abs_err"]["coalesce_adjacent"],
        "bartman_max_abs_err": {
            str(n): r["max_abs_err"]["coalesce_adjacent"]
            for n, r in bartman.items() if "max_abs_err" in r
        },
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_twin_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }, {
        "name": "cumsum",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/scan.cu",
        "replaces": "pysdm_tpu/ops/pallas/scan.py:105",
        "launches": warm_launches["cumsum"],
        "column_launches": column["cumsum"],
        "dejong_column_launches": dejong["cumsum"],
        "column_max_abs_err": column_err["cumsum"],
        "straub_sort_launches": straub_k4["launches"],
        "kreidenweis_launches": kreidenweis["k4_launches"],
        "jaruga_launches": jaruga["k4_launches"],
        "rozanski_launches": isotope_record["card"]["k4_launches"],
        "resume_launches": resumed["launches"]["cumsum"],
        "resume_max_abs_err": resumed["max_abs_err"]["cumsum"],
        "distributed_launches": distributed["launches"]["cumsum"],
        "distributed_max_abs_err": distributed["max_abs_err"]["cumsum"],
        "mg2007_launches": mg2007["launches"]["cumsum"],
        "mg2007_max_abs_err": mg2007["k4_max_abs_err"],
        "bartman_launches": {
            str(n): r["launches"]["cumsum"] for n, r in bartman.items()
        },
        "bartman_max_abs_err": {
            str(n): r["max_abs_err"]["cumsum"]
            for n, r in bartman.items() if "max_abs_err" in r
        },
        "max_abs_err": max(k4_err, straub_k4["max_abs_err"],
                           mg2007["k4_max_abs_err"]),
        "straub_sort_max_abs_err": straub_k4["max_abs_err"],
        "ms": k4_ms,
        "plain_ms": k4_twin_ms,
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        # the twin is the library call, torch.cumsum in the input's dtype
        "library_ms": k4_twin_ms,
    }, {
        "name": "coalesce_breakup_mirror",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_breakup.cu",
        "replaces": "pysdm_tpu/ops/pallas/breakup.py:340",
        "launches": k5_launches,
        "bulenok_launches": bulenok_launches,
        "max_abs_err": k5_err,
        "ms": k5_ms,
        "plain_ms": k5_twin_ms,
        "bound_ms": k5_bound[0],
        "bound_by": k5_bound[1],
        "library_ms": None,
    }, {
        "name": "coalesce_mirror_rows",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_mirror.cu",
        "replaces": "pysdm_tpu/ops/pallas/collision.py:317",
        "launches": k1a_launches,
        "max_abs_err": k1a_err,
        "ms": k1a_times[BERRY_ROWS_N][0],
        "plain_ms": k1a_times[BERRY_ROWS_N][1],
        "bound_ms": k1a_bound[BERRY_ROWS_N][0],
        "bound_by": k1a_bound[BERRY_ROWS_N][1],
        "library_ms": None,
        "ms_2_20": k1a_times[N_MAIN][0],
        "rotated_ms_2_20": k1a_rotated_ms,
        "plain_ms_2_20": k1a_times[N_MAIN][1],
        "bound_ms_2_20": k1a_bound[N_MAIN][0],
        "parameterized_launches": k1p_launches,
        "parameterized_ms": k1p["times"][BERRY_ROWS_N][0],
        "parameterized_bound_ms": k1p_bound[BERRY_ROWS_N][0],
        "parameterized_ms_2_20": k1p["times"][N_MAIN][0],
    }, {
        "name": "coalesce_mirror_parameterized",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/collision_mirror.cu",
        "replaces": "pysdm_tpu/ops/pallas/collision.py:317 (with"
                    " Parameterized.pairwise, XLA-fused before it)",
        "launches": k1p_launches,
        "max_abs_err": k1p["max_abs_err"],
        "ms": k1p["times"][BERRY_ROWS_N][0],
        "plain_ms": k1p["times"][BERRY_ROWS_N][1],
        "bound_ms": k1p_bound[BERRY_ROWS_N][0],
        "bound_by": k1p_bound[BERRY_ROWS_N][1],
        "library_ms": None,
        "ms_2_20": k1p["times"][N_MAIN][0],
        "plain_ms_2_20": k1p["times"][N_MAIN][1],
        "bound_ms_2_20": k1p_bound[N_MAIN][0],
    }, {
        "name": "equilibrate_H",
        "route": "cuda",
        "source": "pysdm_tpu_torch/csrc/chemistry.cu",
        "replaces": "pysdm_tpu/ops/chemistry.py:74 (XLA-fused in the"
                    " reference; no Pallas kernel)",
        "launches": kreidenweis["pH_launches"] + jaruga["pH_launches"],
        "kreidenweis_launches": kreidenweis["pH_launches"],
        "jaruga_launches": jaruga["pH_launches"],
        "kreidenweis_float32_launches":
            model_phases["kreidenweis_float32_vs_float64"]["pH_launches"]["card"],
        "launches_per_kreidenweis_step": kreidenweis["pH_launches_per_step"],
        "max_abs_err": pH_solve["max_abs_err_log_H"],
        "err_unit": "log H",
        "drops_differing": pH_solve["differ"],
        "drops": pH_solve["drops"],
        "ms": pH_solve["ms"],
        "plain_ms": pH_solve["plain_ms"],
        "bound_ms": pH_solve["bound_ms"],
        "bound_by": pH_solve["bound_by"],
        "library_ms": None,
        "ms_2_20": pH_solve["ms_2_20"],
        "bound_ms_2_20": pH_solve["bound_ms_2_20"],
        # one thread a drop; the block as the built source sets it
        "threads_per_block": _source_constant("chemistry.cu", "THREADS"),
        "checks": pH_solve["checks"],
    }]}))
    left = _child_pids()
    assert not left, f"processes {left} started here are still running"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
