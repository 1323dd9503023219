#!/usr/bin/env python3
"""Quickest proof that tpulbm_torch runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Phases, each
printing its own line; any failure exits non-zero:

1. the card: torch.cuda must see it; nvidia-smi's name and power limit;
2. build: nvcc compiles tpulbm_torch/csrc/step_d2q9.cu,
   step_d2q9_blocked.cu, step_d3q19.cu, step_d3q19_blocked.cu,
   step_thermal.cu and step_multiphase.cu, the two D2Q9 sources once more
   for each other collision mode (TRT, MRT, regularized, KBC, Smagorinsky,
   power law), the two D3Q19 sources for each but KBC, the thermal source
   for the Smagorinsky closure and every domain, source, obstacle and ring
   build of the later phases, in a pool beside the phases (Builds: in the
   order the phases first need them, on every core but the one this
   process keeps; a phase waits for a library still building); ptxas's
   registers, shared memory and spills for each instantiation are printed
   once all are built, the dynamic shared memory the N-step and D3Q19
   kernels ask for here;
3. kernels against plain at 2048x512 (re200): one step of the 1-step
   kernel from the initial state and from a state the plain step advanced
   500 steps, at rtol 5e-6 / atol 1e-7; 280 steps of each (max error
   printed and bounded); the N-step kernel at N = 2, 3, 4 from the same
   two states against N launches of the 1-step kernel (bitwise) and
   against N plain steps (N times the one-step tolerance); 280 steps as
   70 N=4 launches against 280 1-step launches (bitwise); then the port's
   Runner on a 64x32 cylinder through the kernels and through the plain
   step;
4. the main path: tpulbm_torch.runner.Runner on re200 at 2048x512 f32,
   2800 steps at output_frequency 140, no VTK: two super-chunks of 8
   intervals, three 140-step chunks, a 139-step chunk and the last step.
   Launch counts must be exactly 665 (N=4), 140 (1-step), 0 (N=2, N=3),
   with 20 finite force rows; the loop's host fetches are printed;
4b. resume: 1120 steps with checkpoint_every=8 (the checkpoint lands at
   t = 1119), resumed to 2800: forces.csv and velocity_field.csv equal
   the straight run's byte for byte;
4c. the cascade's other depths through the Runner: 311 steps at
   output_frequency 150 run two 150-step chunks at N=3 and a 10-step
   chunk at N=2 (100 N=3, 5 N=2 and 1 1-step launches), and write the
   same bytes as the same run with blocking off (TPULBM_NO_FUSED2);
5. timing at 2048x512, CUDA events, in turns: the plain step, the 1-step
   kernel and the N = 2, 3, 4 kernels, per step, and the N=4 time against
   the 0.01940 ms/step it took before the domains (RE200_N4_BEFORE_MS);
6. D3Q19 parity at 256^3 (bench.py's d3q19 row: the sphere in a duct,
   tau 0.6, U = 0.05): one kernel step against the plain 3-D step from the
   initial state and from a state the plain step advanced 100 steps, at
   rtol 5e-6 / atol 1e-7; 280 kernel steps against 280 plain steps (max
   error bounded by 1e-4);
6b. the N-step D3Q19 kernel at 256^3, N = 2 and 3, from the same two
   states: bitwise against N launches of the 1-step kernel and against N
   plain steps at N times the one-step tolerance; 280 steps as tpulbm's
   plan [(3, 92), (2, 2)] bitwise against 280 1-step launches;
7. the 3-D main path: the Runner at 256^3 f32, 2240 steps at
   output_frequency 140, no VTK (one super-chunk of 8 intervals, seven
   140-step chunks, a 139-step chunk and the last step), through tpulbm's
   plan: exactly 735 N=3, 17 N=2 and 1 one-step D3Q19 launches and none
   of another kernel, 16 finite force rows, a finite fields3d.npz of
   (256, 256, 256) arrays; host fetches, wall time and runner MLUPS
   printed; forces.csv and fields3d.npz within the artifact tolerance
   (tests/test_torch_3d.py's) of the same run with blocking off
   (TPULBM_NO_FUSED2: 2240 one-step launches);
8. timing at 256^3, in turns: the plain 3-D step (2 steps a turn), the
   1-step D3Q19 kernel and the N = 2, 3 kernels (500-501 steps a turn),
   ms/step, MLUPS, GB/s and the share of each kernel's bound. The 3-D
   tensors are freed at the end;
9. thermal parity (D2Q9 flow + D2Q5 temperature, Boussinesq): at bench.py's
   thermal row (Rayleigh-Benard, Ra 1e4, tau 0.55, thermal_tau 0.5704,
   2048x512, periodic x), the heated cavity at 96x96 and both problems at
   a ragged 100x70: one kernel step against one plain thermal step from
   the initial state and from a state the plain step advanced 500 steps,
   at rtol 5e-6 / atol 1e-7, and 280 kernel steps against 280 plain steps
   (max error bounded by 1e-4);
10. the thermal main path: the Runner on that 2048x512 problem in f32,
   2240 steps at output_frequency 140, no VTK: exactly 2240 launches of
   the thermal kernel and none of a D2Q9 or D3Q19 kernel, 16 finite
   nusselt.csv rows, a finite 1,048,576-row temperature_field.csv, no
   forces.csv; host fetches, wall time, runner MLUPS and the final Nu;
11. thermal physics through the Runner: the heated-cavity preset (96^2,
   Ra 1e4, 120,000 steps) ends within 3% of de Vahl Davis's Nu = 2.243,
   and the rayleigh-benard preset (128x64, Ra 1e4, 60,000 steps) ends
   with 2 < Nu < 3 (convecting, not conductive, not running away);
12. thermal timing at 2048x512, in turns: the plain thermal step and the
   kernel, ms/step, MLUPS, GB/s and the share of 3.35 TB/s at 112 B/cell;
13. multiphase parity (Shan-Chen, D2Q9): at bench.py's multiphase row (a
   droplet of radius 0.15 ny, g -5, tau 1.0, 2048x512, periodic x), the
   64x32 band with a wetting wall (wall rho 1.6) and droplets at a ragged
   7x3 and 100x70: one kernel step against one plain step from the
   initial state and after 500 plain steps, at rtol 5e-6 / atol 1e-7;
   280 steps at 2048x512 (max error bounded by 1e-4);
14. the multiphase main path: the Runner on that droplet in f32, 2240
   steps at output_frequency 140, no VTK: exactly 2240 launches of the
   multiphase kernel and none of another kernel, no forces.csv, a finite
   1,048,576-row velocity_field.csv holding the physical velocity
   u + F/(2 rho) of the state 2239 kernel steps on (not the bare
   moments), total mass within 1e-5 of t = 0 once the float32 weights'
   known excess (2^-27 a step, MP_WEIGHT_EXCESS) is taken off, and within
   1e-6 of the plain step's; host fetches, wall time and runner MLUPS;
15. multiphase physics, the kernel in f32 at tests/test_multiphase.py's
   sizes and thresholds: phase separation (the 64x32 band, 2000 steps,
   rho_max/rho_min > 5, a flat liquid interior), the Laplace law (80x80
   droplets of radius 0.12 and 0.20 ny, 6000 steps each, dP > 0,
   R2 > R1 > 3, sigma from the two within 20%), wettability (96x48,
   4000 steps at wall rho 1.6, 1.0, 0.16: the spread width orders
   strictly);
16. multiphase timing at 2048x512, in turns: the plain step and the
   kernel, ms/step, MLUPS, GB/s and the share of its bound at 72 B/cell;
17. the 2-D operators at the re200 preset, 2048x512, with the kernel
   ladder's flags (OPERATORS: TRT with the clean Zou-He corners, MRT with
   e=1.857, regularized, KBC, Smagorinsky 0.17, power law n 0.7), each
   through its own build of the D2Q9 kernels: one 1-step kernel step
   against one plain step from the initial state and after 500 plain
   steps, at rtol 5e-6 / atol 1e-7 (the power law at rtol 1e-4, tpulbm's
   _PLAW_RTOL; KBC, where that fails, at max|d|/max|f| < 3e-5, tpulbm's
   KBC gate, and the line says which held); 280 kernel steps against 280
   plain steps (bounded by 1e-4); the N-step kernel at N = 2, 3, 4
   bitwise against N 1-step launches from both states;
18. each operator's main path: the Runner at 2048x512 f32, 2240 steps
   every 140, no VTK: exactly 525 N=4 and 140 1-step launches, all of the
   operator's libraries, and none of another kernel; 16 finite force rows
   and a finite velocity field; wall time, runner MLUPS, host fetches and
   the final C_D printed; phase 4c's 311-step run (100 N=3, 5 N=2, 1
   1-step launches), byte-identical to the run with blocking off; then the
   64x32 Runner through the kernel and the plain step, as in phase 3;
19. tpulbm's operator gates through the kernels in f32: the LES headline
   (256x64, tau 0.503, U 0.1, 4000 steps: BGK blows up, Smagorinsky 0.17
   stays finite) and the MRT boundary-feedback gate (256x64, tau 0.5768,
   2000 steps: finite, max|u| < 0.25; tpulbm runs it in f64);
20. each operator's timing at 2048x512, in turns: the plain step, the
   1-step kernel and the N = 2, 3, 4 kernels, ms/step, MLUPS and the share
   of each kernel's bound (MODE_FLOPS counts each collision's
   operations). The phases' total time is printed;
21. the sphere's operators at 256^3 (bench.py's d3q19 row; OPERATORS_3D:
   TRT, MRT at D3Q19's default rates, regularized, Smagorinsky 0.17, power
   law n 0.7), each through its own build of both D3Q19 kernels: one
   1-step kernel step against one plain step from the initial state and
   from the state its 1-step kernel advanced 100 steps (the power law at
   rtol 1e-4); N = 2, 3 bitwise against N 1-step launches from both
   states; 280 kernel steps against 280 plain steps at 128^3 (bounded by
   1e-4); tpulbm's own 3-D gate of the operator (GATES_3D), the kernels
   against the plain step;
22. each operator's 3-D main path: the Runner at 256^3 f32, its depth
   cut to 280 steps every 140 (CUT_3D_STEPS), no VTK: exactly 91 N=3, 3
   N=2 and 1 one-step launches of that operator's libraries and none of
   another kernel, 2 finite force rows and a finite fields3d.npz; wall
   time, runner MLUPS, host fetches and the final C_D;
23. each operator's timing at 256^3, in turns: the plain step, the 1-step
   kernel and the N = 2, 3 kernels, ms/step, MLUPS and the share of each
   kernel's bound (MODE_FLOPS_3D). The phases' total time is printed;
24. the thermal step's Smagorinsky closure (Cs 0.17) at the 2048x512
   Rayleigh-Bénard row through the thermal kernel's LES build: one step
   against the plain LES step from both states, 280 steps; tpulbm's LES
   gate of the thermal kernel (32x32, Ra 5000, 12 steps, rtol 2e-5 / atol
   1e-6); the Runner (exactly 2240 launches of the LES build, 16 finite
   nusselt.csv rows, the final Nu); timing against the plain step;
25. the kernels' new domains, source and obstacle rule in 2-D, each
   through its own library (step_cuda.build_defines): the body-forced
   channel at 2048x512 (tau 0.8, F = (1.53e-7, 0), u_max 0.0499) under
   each D2Q9 collision, the lid-driven cavity at 1024^2 (Re 1000, U 0.1,
   tau 0.8069), the re200 cylinder with the bounce-back obstacle and with
   the channel's force: one 1-step kernel step against one plain step
   from the initial state, after 500 plain steps and from the seeded
   perturbed state (rtol 5e-6 / atol 1e-7; the cavity 2e-5 / 5e-7,
   tpulbm's cavity gate; the power law rtol 1e-4). On the perturbed state
   the cylinder's library of the same collision (the obstacle domain, the
   equilibrium obstacle, no source) must miss the plain step by more than
   SEPARATION tolerances where the domain or the obstacle rule differs;
   where the library has the source, one step at F = 1e-2
   (SOURCE_CHECK_FORCE) must meet the plain step and the same domain's
   library built without the source must miss it by SEPARATION
   tolerances. N = 2, 3, 4 bitwise against N 1-step launches from each
   state; 280 steps within 1e-4. The channel's TRT, regularized, KBC and
   Smagorinsky builds from the perturbed state at N = 4 only;
26. their main paths: the Runner, 2240 steps every 140, no VTK: exactly
   525 N=4 and 140 1-step launches of the cell's own library and none of
   another kernel, a finite 1M-row field (forces.csv only with the
   obstacle); the cavity's total mass at t = 2240 (its checkpoint) within
   1e-6 of the start; the channel's 311-step run every 150 (100 N=3, 5
   N=2, 1 1-step launches); host fetches, wall time and runner MLUPS;
27. the duct at 256^3 (tau 0.8, F for u_max 0.05 by analytic_profile_duct)
   under each D3Q19 collision, the sphere at 256^3 with the bounce-back
   obstacle and with the channel's force: phase 25's checks (100 kernel
   steps for the advanced state, N = 2, 3; 280 steps at 128^3; the duct's
   other collisions from the perturbed state only);
28. their main paths at 256^3, cut to 280 steps every 140: exactly 91
   N=3, 3 N=2 and 1 one-step launches of the cell's own library, then
   tpulbm's physics gates through the kernels in f32: Poiseuille (32x32,
   RMSE < 0.005 and < 2% of u_max), the power-law channel (16x24, n 0.5
   and 1.5, < 4%), Ghia at Re 100 (64^2, 30000 steps, nine bounds) and the
   duct's Fourier series (8x17x17, < 2%);
29. timing of each new library against its plain step, in turns: ms/step,
   MLUPS and the share of the bound (72 B a cell in 2-D and 152 in 3-D
   where the kernel reads no mask; the source's adds counted). Each
   phase group's time is printed;
30. the mesh of shards (tpulbm_torch/parallel/, several shards on this one
   card): the ring builds of both D2Q9 sources (-DTPULBM_RINGS=1, built in
   phase 2, ptxas's report printed) on a (1,1) mesh at re200, 1-step and
   N = 2, 3, 4, with and without x rings, from the initial and the
   perturbed state, bitwise equal to today's builds;
31. one launch per shard at re200 on (4,1) (ring rows), (1,4) and (2,2)
   (x rings too, corners from the diagonal shards) at N = 1-4, and the
   overlap mode's three ranged launches a shard on (4,1) at N = 1 and 4,
   from the initial and the perturbed state: each shard against its plain
   ring step (ops/step_rings_torch.py) at N times the one-step tolerance,
   the mesh bitwise equal to the one-device kernel; on the perturbed state
   rings of the frozen equilibrium on the shard edges must miss the plain
   step by SEPARATION tolerances;
32. 280 steps of re200 on each mesh and in the overlap mode on (4,1), and
   40-42 steps at the other depths (TPULBM_NO_FUSED2, TPULBM_SUBSTEPS), each
   counted (the launches per library, depth and shard the chunk plan
   gives, none of another kernel) and bitwise equal to the one-device
   chunk at the same depth;
33. the main path: the Runner on scale-8m (4096x2048, BASELINE config 4)
   on a 2x2 mesh, devices=[cuda:0]*4, 2000 steps at output_frequency 500,
   no VTK: exactly the launches per library, depth and shard that the
   chunk plan gives for the Runner's chunks (375 N=4 and 500 1-step a
   shard), none of another kernel; host fetches, wall time and runner
   MLUPS; forces.csv and velocity_field.csv within rtol 1e-4 / atol 5e-6
   of the one-device run's;
34. timing, in turns: the ring builds against today's at re200 on (1,1)
   (1-step, N = 2, 3, 4), and one shard's launch at scale-8m's shapes
   (2x2 with x rings at N = 1-4, 4x1 with ring rows at N = 1, 2, 4, the
   overlap mode's three ranged launches at N = 1 and 4) against its plain
   ring step, with the bound (73/N B a cell and the rings' bytes);
35. the periodic box (-DTPULBM_DOMAIN=3: x and y wrap, no walls) and the
   force profile (-DTPULBM_FORCE=1, a table of the source per coordinate),
   built in phase 2: Taylor-Green at 2048x512 (bench.py's --periodic row,
   tau 0.8, u0 0.04) under each D2Q9 collision and Kolmogorov (its
   --kolmogorov row: n 4, tau 0.8, u0 0.05, F0 = 1.2e-5) under BGK and
   MRT and with its force turned along x: one 1-step kernel step against
   the plain step from the perturbed state (BGK also from the initial
   state, after 500 plain steps, and 280 steps), where the cylinder's
   library of the same collision must miss by SEPARATION tolerances; the
   force profile at F0 = 1e-2 (SOURCE_CHECK_FORCE) along y and along x
   against the plain step, the box's library without the profile
   SEPARATION tolerances off; N = 2, 3, 4 (N = 4 for the other
   collisions) bitwise against N 1-step launches;
36. Taylor-Green's and Kolmogorov's main paths through the Runner, 2240
   steps every 140: exactly 525 N=4 and 140 1-step launches of the box's
   library (bgk+box, bgk+box+force) and none of another kernel, a finite
   field; the flow's mass after 2240 kernel steps between the start and
   the float32 weights' e/tau a step (box_mass_gate, 1e-6 either way);
   Taylor-Green's 311-step run every 150 (100 N=3, 5 N=2, 1 1-step);
37. both on (2,2), (4,1), (1,4) with every shard on the card: one launch a
   shard at N = 1 and 4 from the perturbed state against its plain ring
   step and bitwise against one device (the rings wrap in y; equilibrium
   rings SEPARATION tolerances off), 280 steps counted and bitwise
   against the one-device chunk, the Runner on 2x2 (560 steps every 140)
   counted, its velocity_field.csv byte-identical to one device's;
38. the passive scalar through the thermal kernel with its wall flags off
   (step_thermal.cu unchanged): one step against the plain thermal step
   at 2048x512, at rest and stirred (u0 0.04, thermal_tau 0.5704), from
   the initial, an advanced and the perturbed state; 280 steps; the
   Runner, 2240 steps every 140: exactly 2240 thermal launches, 16 finite
   falling rows of scalar_variance.csv in tpulbm's layout, no
   nusselt.csv; the flow's and the scalar's mass after 2240 kernel steps
   (D2Q5's weights sum to 1 + 2^-25); timing;
39. tpulbm's periodic gates through the kernels in f32: Taylor-Green's
   nu within 0.5%, Kolmogorov's fixed point within 1.5% and spin-up
   within 2%, the scalar's diffusion rate within 1e-3, advection's
   phase, stirring at least halving the variance, the shear-layer preset
   finite under regularized;
40. timing of the box's libraries (plain, 1-step, N = 2-4) and of one
   shard's ring launch of the 2x2 mesh at N = 1 and 4, with the bound (72
   B a cell: the box reads no mask; the profile's adds counted);
41. the Bouzidi curved wall (-DTPULBM_BOUZIDI=1, built in phase 2: both
   D2Q9 sources under each D2Q9 collision, both D3Q19 sources under each
   D3Q19 collision, the BGK ring builds): the re200 cylinder with
   obstacle_bc="bouzidi" (bench.py's bouzidi row) under each D2Q9
   collision with the ladder's flags, and spinning under BGK (surface
   speed = the inlet speed): one 1-step kernel step against the plain
   step from the initial state, after 500 plain steps (BGK) and from the
   perturbed state, where the library without the rewrite (the
   equilibrium obstacle's) must miss by SEPARATION tolerances; N = 2, 3,
   4 bitwise against N 1-step launches; 280 steps;
42. their Runners, 2240 steps every 140: exactly 525 N=4 and 140 1-step
   launches of the library (bgk+bouzidi, ...); BGK's 311-step run every
   150 (100 N=3, 5 N=2, 1 1-step); a 64x32 Runner through the kernels
   against the plain step, still and spinning;
43. the still cylinder on meshes, every shard on the card: one launch a
   shard from the perturbed state on (2,1) at N=4, (1,2) and (2,2) at
   depth 1 (tpulbm's depth for it on a mesh that cuts x) and (4,1) in the
   overlap mode, against the plain ring step and bitwise against one
   device; on (2,1) the equilibrium rings and a link table whose rings
   read -1 SEPARATION tolerances off; 280 steps on each, counted and
   bitwise against one device; the Runner on each (2240 steps every 140),
   its forces.csv and velocity_field.csv byte-identical to one device's;
44. the sphere at 256^3 (bench.py's bouzidi3d row: radius 0.23, x = y =
   0.5) under each D3Q19 collision: parity from the perturbed state with
   N=3 bitwise (BGK in full: from the initial state, after 100 kernel
   steps, N = 2, 3, 280 steps at 128^3; every operator's Runner cut to
   280 steps, 91 N=3, 3 N=2 and 1 one-step launches, BGK's too);
   tpulbm's Magnus gate through the kernels (200x50, 4000 steps: the lift
   flips with the spin, the drag symmetric);
45. timing of each Bouzidi library (plain, 1-step, the main path's
   depths) and of one shard's ring launch on (2,1) at N=4 and (1,2) at
   depth 1, with the bound counting the link table's bytes at the cells
   that have a cut link;
46. the fully periodic 3-D boxes, 3-D Kolmogorov's force along z and the
   D3Q27 set (-DTPULBM_DOMAIN=3, -DTPULBM_FORCE=1, -DTPULBM_Q=27, built in
   phase 2): periodic3d-256 (bench.py's --periodic --nz 256 row),
   kolmogorov3d-128 (the preset) and sphere-256-d3q27 in full (from the
   initial state, after 100 kernel steps and from the perturbed state),
   the box with the force under every D3Q19 collision and D3Q27 under
   every collision but MRT (the box, the sphere, bounce-back, the duct)
   at 64^3 from the initial and the perturbed state: one 1-step kernel
   step against the plain step, where the sphere's library, the box's
   without the force, D3Q19's on the first 19 planes and BGK's (against
   a closure) must miss by SEPARATION tolerances; N = 2, 3 bitwise
   against N 1-step launches; 280 steps, every cell's at 64^3;
47. the three cells through the Runner, 2240 steps every 140
   (periodic3d-256 and the D3Q27 sphere cut to 280 steps: 91 N=3,
   3 N=2 and 1 one-step launches): exactly 735 N=3, 17 N=2 and 1
   one-step launches of the cell's library and none of another kernel;
   the boxes' mass after the float32 weights' term; kolmogorov3d-128
   with statistics from step 1120 and two probes, its stats_fields.npz
   and probes.csv against the same run on the plain path;
48. 2-D Kolmogorov at 2048x512 with statistics and probes on a 2x2 mesh
   of shards on the card: stats_fields.npz, probes.csv and
   velocity_field.csv bit for bit one device's;
49. tpulbm's 3-D gates in f32: the z shear wave's viscous decay (second
   order in nz), the 3-D Taylor-Green energy and mass, 3-D Kolmogorov's
   spin-up from rest;
50. timing of every library of phase 46 (plain, 1-step, N = 2, 3) at its
   cell's shape, with the bound;
51. the 3-D meshes (-DTPULBM_RINGS=1 of both D3Q19 sources, built in
   phase 2 for every library of mesh3d_cases(); ptxas printed): at 64^3,
   the sphere, the bounce-back sphere under TRT, the Bouzidi sphere, the
   duct, the box, the box with the z force, D3Q27's sphere and box and
   one other collision a domain, one launch a shard on (2,2), (4,1) and
   (1,4) at depths 1-3 (the Bouzidi sphere at depth 1 on the x-cut
   meshes, tpulbm's dispatch; depths 1 and 3, each source's build, on
   (4,1) and (1,4)) from the initial and the perturbed state:
   each shard within the N-step tolerance of its plain ring step, every
   mesh bitwise one device, equilibrium rings SEPARATION tolerances off;
   N-step ring launches bitwise N 1-step ones; MRT, regularized, LES and
   the power law one case each on (2,2) at N=3;
52. the main path: sphere-256 (bench.py's d3q19 row) on a 2x2 mesh of
   256x128x128 shards on the card through the Runner, 2240 steps every
   140: exactly 735 N=3, 17 N=2 and 1 one-step ring launch a shard, none
   of another kernel, the final state bitwise one device's, forces.csv
   and fields3d.npz's arrays the same bytes; 280-step chunks on (4,1),
   (1,4) and tpulbm's 4x2 bitwise one device;
53. the Bouzidi sphere at 256^3 (bench.py's bouzidi3d row), 280 steps on
   (2,1) (blocked), (1,2) and (2,2) (depth 1), and spinning on (2,2):
   bitwise one device, the cut-link force within rtol 1e-4 / atol 5e-6;
54. through the Runner against one device, 280 steps every 140:
   periodic3d-256 on (2,2), kolmogorov3d-128 on (2,2) with statistics
   from step 140 and two probes (stats_fields.npz and probes.csv the
   same bytes), the D3Q27 sphere at 128^3 on (2,2), the duct at 128^3 on
   (1,2): counted, the final state bitwise;
55. timing in turns: the four shards' ring launches of sphere-256 on 2x2
   summed against the one-device kernel at N = 1, 2, 3, one shard's
   launch against its bound (the kernel's bytes a cell and the rings')
   and its plain ring step; (4,1) at N=3; the Bouzidi sphere on (2,1) at
   N=3 and (2,2) at depth 1. Each phase prints its seconds;
56. the thermal problems and multiphase on meshes of shards on the card
   through the ring builds of csrc/step_thermal.cu (BGK and the
   Smagorinsky closure) and csrc/step_multiphase.cu (-DTPULBM_RINGS=1,
   built in phase 2): one launch a shard from the perturbed state within
   the one-step tolerance of its plain ring step, every mesh bitwise one
   device's kernel step, rings of the frozen equilibrium SEPARATION
   tolerances off: rb-2048x512 on (2,2), (4,1), (1,4), its LES on (2,2),
   the heated cavity 96^2 and the passive scalar 2048x512 on (2,2), the
   droplet 2048x512 on (4,1) and (2,2);
57. the thermal main path: rb-2048x512 (bench.py's thermal row) on a 2x2
   mesh through the Runner, 2240 steps every 140, held to phase 10's
   one-device run: 2240 ring launches a shard and none of another kernel,
   the final state bitwise, temperature_field.csv and velocity_field.csv
   the same bytes, nusselt.csv within rtol 1e-4 / atol 5e-6;
58. 280 steps of rb on (4,1) and (1,4), its LES and the heated cavity on
   (2,2), bitwise one device; the passive scalar 2048x512 on (2,2)
   through the Runner (280 steps): scalar_variance.csv within the same
   tolerance, its fields the same bytes;
59. multiphase: the droplet 2048x512 on tpulbm's dryrun layout (4,1)
   through the Runner, 2240 steps, held to phase 14's one-device run
   (velocity_field.csv, the physical velocity of padded blocks, the same
   bytes); the band on (2,2), 280 steps bitwise and its physical velocity
   bitwise one device's;
60. timing in turns, the card's time (launches enqueued behind a
   torch.cuda._sleep, as a shard's launch is shorter than the host's
   issue): the one-device kernel, the shards' ring launches summed and
   one shard's launch, beside the same launches as the host issues them
   and one shard's plain ring step, for rb on (2,2) and (4,1), its LES on
   (2,2), the droplet on (4,1) and (2,2); and row 4's box build (the
   overlap mode's three ranged launches of Taylor-Green on (4,1));
61. the Bouzidi sphere on D3Q27 (-DTPULBM_Q=27 -DTPULBM_BOUZIDI=1 of both
   D3Q19 sources under BGK, TRT, regularized, Smagorinsky and the power
   law, built in phase 2) at 256^3 (bench.py's bouzidi3d row on D3Q27):
   its cut links counted; one 1-step kernel step against the plain step
   from the initial state, after 100 kernel steps and from the perturbed
   state, where the equilibrium obstacle's library and D3Q19's on the
   first 19 planes must miss by SEPARATION tolerances; N = 2, 3 bitwise;
   280 steps at 64^3; the build fed a staircase table (every cut link
   at q = 1/2) SEPARATION tolerances off; the Runner for 280 steps
   every 140 (91 N=3, 3 N=2, 1 1-step launches); a 128^3 Runner's
   forces.csv against the plain path's; the other collisions and the
   spinning sphere at 64^3, each with a counted 280-step run;
62. the D3Q27 Bouzidi sphere at 128^3 on meshes (the ring builds): one
   launch a shard on (2,1) at N = 3 and 2, (2,2) at depth 1 and, spinning,
   (2,1) at N = 3, against the plain ring step and bitwise one device,
   equilibrium rings off; 280 steps on (2,1), (2,2) (and spinning on
   (2,1)) bitwise one device with the force per shard; a (2,1) Runner's
   forces.csv against phase 61's one-device run;
63. the solid-slab channel (-DTPULBM_DOMAIN=1 -DTPULBM_SLAB=1: periodic
   x, no y walls, the walls solid rows at fractional q) at 2048x512
   (tpulbm's _channel_problem geometry, qb 0.25, qt 0.75, tau 0.8, F for
   a peak speed 0.05) under Bouzidi: its cut links counted; one step
   against the plain step from the initial and the perturbed state (the
   obstacle domain's library off, the source's check), N = 2, 3, 4
   bitwise, 280 steps, the staircase table off; the stepper for 2240
   steps in the Runner's chunks (525 N=4 + 140 1-step launches); the
   bounce-back and equilibrium builds, the moving top wall (Couette, no
   source) and the other collisions at 256x64, each with a counted
   280-step run;
64. tpulbm's slab gates through the kernels in f32: the fractional walls
   (24x8, 6000 steps, both wall pairs; tpulbm's bounds); the staircase
   contrast and Couette (20x8, 8000 steps), whose f64 bounds f32 cannot
   reach, held to the f32 plain step's own result on the same run;
65. the slab on (2,1) at N=4, (1,2) and (2,2) at depth 1: one launch a
   shard against the plain ring step, bitwise one device, equilibrium
   rings off; 280 steps on each counted and bitwise one device, the force
   per shard;
66. timing: the D3Q27 Bouzidi kernels at 1-step, N = 2, 3 against the same
   sphere's library without the rewrite in the same turns, the slab's
   1-step and N=4 against the walled channel's build, their ring builds,
   the other builds against their plain steps; bounds with the link
   table's bytes.

Run directories go to build/chip_smoke/ (git-ignored; the final CSVs have
a million rows). The last two lines are a JSON line per kernel and the
result line; a kernel's `launches` is its count in the run that drives
it through the Runner: phase 4 for the 1-step and N=4 kernels, phase 4c
for N=2 and N=3, phase 7 for the D3Q19 kernels, phase 10 for the thermal
kernel, phase 14 for the multiphase kernel, phase 18 for each operator's
kernels (named d2q9_collide_stream[op] and d2q9_collide_stream_nN[op]:
the 1-step and N=4 launches from its main path, N=2 and N=3 from its
311-step run), phase 22 for each 3-D operator's
(d3q19_collide_stream[op], d3q19_collide_stream_nN[op]) and phase 24 for
the thermal LES build (thermal_collide_stream[smagorinsky]), phases 26 and 28
for each new library (d2q9_collide_stream[<library>],
d2q9_collide_stream_n4[<library>], the channel's N=2 and N=3 from its
311-step run; d3q19_collide_stream[<library>] and _nN: StepConstants.library
names the library, e.g. "mrt+channel+source"), phases 32-33 for the
ring builds (d2q9_rings_<mode>[_nN], <mode> the chunk's: "tiled" with x
rings, "rows" without, "overlap" ranged; the tiled 1-step and N=4
launches from the main path, the rest from phase 32's runs), phase 36 for
the box's libraries (d2q9_collide_stream[bgk+box], ...[bgk+box+force]),
phase 37's 2x2 Runner for their ring builds
(d2q9_rings_tiled[_n4][bgk+box...]), phase 38 for the scalar
(thermal_collide_stream[passive_scalar]), phase 42 for the Bouzidi
libraries (d2q9_collide_stream[_nN][<op>+bouzidi], the spinning
cylinder's d2q9_collide_stream[_n4]_spinning[bgk+bouzidi]), phase 43's
280-step runs for their ring builds (d2q9_rings_rows_n4[bgk+bouzidi], counting
the overlap mode's ranged launches, and d2q9_rings_tiled[bgk+bouzidi])
and phase 44 for the sphere's (d3q19_collide_stream[_nN][<op>+bouzidi]),
phase 47 for the 3-D boxes' and D3Q27's (d3q19_collide_stream[_nN]
[bgk+box], [bgk+box+force], [bgk+d3q27]; their 64^3 builds 0), phase
52's main path for the 3-D ring builds (d3q19_rings_tiled[_nN][bgk], the
four shards' launches; the others timed in phase 55 with 0), phases 57
and 59 for the thermal and multiphase ring builds
(thermal_rings_tiled[bgk], multiphase_rings_rows[bgk]: the four shards'
launches of the main paths; thermal_rings_rows[bgk],
thermal_rings_tiled[smagorinsky] and multiphase_rings_tiled[bgk] from
phases 58-59's 280-step runs; `ms` one shard's launch, the card's time),
phase 61 for the D3Q27 Bouzidi libraries
(d3q19_collide_stream[_nN][<op>+bouzidi+d3q27], the spinning sphere's
..._spinning[bgk+bouzidi+d3q27]; the 64^3 ones from their counted runs),
phase 62's (2,1) Runner for their ring builds
(d3q19_rings_rows_nN[bgk+bouzidi+d3q27]; the (2,2) depth-1 build 0),
phase 63 for the slab's (d2q9_collide_stream[_nN][<op>+channel+slab
+source+bouzidi], ...[bgk+channel+slab+source+bounce_back],
...[bgk+channel+slab+source], the moving wall's ..._moving[bgk+channel
+slab+bouzidi]; N=2 and N=3 0) and phase 65's runs for their ring builds
(d2q9_rings_rows_n4[...], d2q9_rings_tiled[...]).
A kernel's
`bound_ms` is the
least time the card could take for one step of its work at the shape it
was timed at: the larger of the bytes a step must move (each population
read once and written once, the solid mask read once) over 3.35 TB/s and
its floating-point operations over the 67 TFLOP/s float32 peak;
`library_ms` is null, as no single PyTorch call computes a
lattice-Boltzmann step.
"""
from __future__ import annotations

import dataclasses
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
ONE_STEP_TOL = dict(rtol=5e-6, atol=1e-7)
DEPTHS = (2, 3, 4)
DEPTHS_3D = (2, 3)
# tests/test_torch_3d.py's gates on a 3-D run's artifacts: forces (C_D and
# C_L scaled by the dynamic pressure) and the final fields
FORCES_TOL = dict(rtol=1e-4, atol=5e-6)
FIELDS_TOL = dict(rtol=1e-5, atol=5e-6)
# 280 steps of f32 rounding differences (1/rho multiplied vs divided, sum
# order) from an impulsive start: a divergence bound, not a parity gate
DRIFT_280_BOUND = 1e-4
# the plain step's turns in the timing phases (its time is the reference a
# kernel's is read against, not a gate): 2-D and thermal 40 steps a turn,
# 3-D 2, after PLAIN_WARM steps
PLAIN_2D_STEPS = 40
PLAIN_3D_STEPS = 2
PLAIN_WARM = 1
# a 3-D kernel's turns in cell_timing (75 steps, at least 75 ms a turn at
# 256^3), after 10 warm-up steps
KERNEL_3D_STEPS = 75
# the re200 N=4 BGK kernel's time before the ring builds (PERF.md §6,
# row 2: the last call of PR 9) on an NVIDIA H100 80GB HBM3 at 700 W: the
# cylinder's libraries keep it
RE200_N4_BEFORE_MS = 0.01895
# the 3-D cell's edge (bench.py's d3q19 row) and the bytes one D3Q19 step
# must move: 19 f32 values per cell read and written once, plus the 1-byte
# solid mask
SPHERE_N = 256
BYTES_3D = SPHERE_N ** 3 * (19 * 4 * 2 + 1)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# per cell and step: bytes a step must move (f32 populations read and
# written once, plus the 1-byte solid mask where the kernel takes one) and
# floating-point operations, counted from the plain version's expressions
# (moments, equilibria, relaxation, source; boundary rows neglected)
STEP_BYTES = {"d2q9": 9 * 4 * 2 + 1, "d3q19": 19 * 4 * 2 + 1,
              "thermal": 14 * 4 * 2, "multiphase": 9 * 4 * 2}
# multiphase: ρ, m and ψ (8 + 10 + 5, expf counted as one operation), the
# ψ-stencil force (25), the shifted velocity (8) and the BGK relaxation (94)
STEP_FLOPS = {"d2q9": 115, "d3q19": 256, "thermal": 165, "multiphase": 150}
# the D2Q9 kernels under the other collisions (csrc/d2q9_common.cuh), per
# cell, counted from the kernel's expressions as above (a division, sqrtf,
# expf or logf counts one operation, min and max one each): TRT's closed
# form; MRT at rank 2, the rank of the ladder's rates (the kernel also runs
# the zero-padded ranks 3-4, 70 more); regularized; KBC; Smagorinsky; the
# power law's 8 Newton steps (16 operations each, 2 of them transcendental)
MODE_FLOPS = {"trt": 163, "mrt": 185, "regularized": 182, "kbc": 313,
              "smagorinsky": 143, "power_law": 272}
for _mode, _flops in MODE_FLOPS.items():
    STEP_BYTES[f"d2q9_{_mode}"] = STEP_BYTES["d2q9"]
    STEP_FLOPS[f"d2q9_{_mode}"] = _flops
# the 2-D operators of the kernel ladder's cells (the D2Q9 cylinder at the
# re200 preset, runs/bench_ladder_r05.jsonl) with their flags
OPERATORS = {
    "trt": dict(collision="trt", zou_he_corners="clean"),
    "mrt": dict(collision="mrt", mrt_rates=(("e", 1.857),)),
    "regularized": dict(collision="regularized"),
    "kbc": dict(collision="kbc"),
    "les": dict(smagorinsky=0.17),
    "power_law": dict(power_law_n=0.7),
}
# the D3Q19 kernels under tpulbm's 3-D collisions (csrc/d3q19_common.cuh),
# per cell, counted from the kernel's expressions as above: the moments,
# c.u and the equilibria (199 of BGK's 256) or the deviations (218), then
# TRT's closed form; MRT's rank-10 U/V (dense: the zero-padded and zero
# entries count); regularized (the six Pi_ab, the projection); Smagorinsky;
# the power law's 8 Newton steps (16 operations each)
MODE_FLOPS_3D = {"trt": 382, "mrt": 1006, "regularized": 526,
                 "smagorinsky": 320, "power_law": 449}
for _mode, _flops in MODE_FLOPS_3D.items():
    STEP_BYTES[f"d3q19_{_mode}"] = STEP_BYTES["d3q19"]
    STEP_FLOPS[f"d3q19_{_mode}"] = _flops
# D3Q27: 27 populations a cell read and written, and D3Q19's
# operation counts scaled by 27/19 (every term of them is a population's;
# bytes bound every D3Q27 build at either count)
STEP_BYTES["d3q27"] = 27 * 4 * 2 + 1
STEP_FLOPS["d3q27"] = round(STEP_FLOPS["d3q19"] * 27 / 19)
for _mode, _flops in MODE_FLOPS_3D.items():
    STEP_BYTES[f"d3q27_{_mode}"] = STEP_BYTES["d3q27"]
    STEP_FLOPS[f"d3q27_{_mode}"] = round(_flops * 27 / 19)
# the sphere's operators at bench.py's d3q19 row: TRT (magic 3/16), MRT
# (D3Q19's default ghost rates, rank 10), regularized, Smagorinsky 0.17,
# the power law at n 0.7 (k = nu)
OPERATORS_3D = {
    "trt": dict(collision="trt"),
    "mrt": dict(collision="mrt"),
    "regularized": dict(collision="regularized"),
    "les": dict(smagorinsky=0.17),
    "power_law": dict(power_law_n=0.7),
}
# tpulbm's own 3-D pallas-vs-jax gate of each operator: grid, tau and steps
# (tests/test_3d.py, test_mrt.py:240-255, test_regularized.py:118-130,
# test_les.py:108-116, test_power_law.py:193-202 at k 0.02), here the
# port's kernels against its plain step
GATES_3D = {
    "trt": (dict(nx=32, ny=16, nz=8, tau=0.6), 8),
    "mrt": (dict(nx=32, ny=16, nz=8, tau=0.6), 3),
    "regularized": (dict(nx=64, ny=16, nz=16, tau=0.6), 12),
    "les": (dict(nx=128, ny=16, nz=16, tau=0.55), 4),
    "power_law": (dict(nx=128, ny=16, nz=16, tau=0.55, power_law_k=0.02), 4),
}
# the 280-step drift of the 3-D operators runs at 128^3: the plain MRT and
# power-law steps are too slow at 256^3 for the script's time
DRIFT_N_3D = 128
# The 3-D Runners of phases 22, 28 and 44 (the Bouzidi sphere's other
# collisions): their depth cut to 280 steps every 140 to keep the script
# near half its time limit, the 3-D main path (phase 7) and the Bouzidi
# sphere's (phase 44, BGK) staying at 2240; tpulbm's plan gives these
# launches a run (depth: launches) for the Runner's chunks 140 x 15, 139,
# 1 and 140, 139, 1
CUT_3D_STEPS = 280
LAUNCHES_3D = {2240: {3: 735, 2: 17, 1: 1}, 280: {3: 91, 2: 3, 1: 1}}
# a 2-D run's N=4 launches at 2240 and 280 steps in the Runner's chunks
# (140 x 15, 139, 1 and 140, 139, 1: the last interval's 139 + 1 steps
# 1-step launches)
LAUNCHES_2D = {2240: 525, 280: 35}
# tpulbm's power-law gate (tests/test_power_law.py's _PLAW_RTOL: a Newton
# solve on expf and logf) and KBC's (tests/test_kbc.py: max|d|/max|f|),
# the latter used only where the one-step tolerance does not hold
PLAW_TOL = dict(rtol=1e-4, atol=1e-7)
KBC_REL_TOL = 3e-5
# From rest, and from a flow near it, every closure's rate rounds to 1/tau
# in float32, so a kernel that skipped its closure would still meet the
# plain step there. Phases 21 and 24 also step a perturbed state (the card
# tests' seeded +-10% noise on the initial state, solid cells back at rest
# equilibrium) and require the BGK library's step there to miss the
# operator's plain step by SEPARATION times the parity tolerance (32^3 and
# 128x64 CPU runs of the plain steps: 580x for Smagorinsky, 830x for the
# power law, 1060x for the thermal closure, 10^4x for TRT, MRT and
# regularized; below 1x from the initial state).
PERTURB_SEED = 7
SEPARATION = 100
# bench.py's thermal row and the physics gates of tests/test_thermal*.py
THERMAL_NX, THERMAL_NY = 2048, 512
DE_VAHL_DAVIS_NU = 2.243
# the thermal step's Smagorinsky closure (Cs), and tpulbm's LES gate of the
# thermal kernel (tests/test_thermal.py:262-288, the `les` case)
THERMAL_CS = 0.17
THERMAL_LES_TOL = dict(rtol=2e-5, atol=1e-6)
# thermal LES: the BGK thermal step's operations (the deviations and the
# relaxation cost what BGK's relaxation costs) and the closure's Pi, Q̄ and
# rate, 27 more
STEP_BYTES["thermal_smagorinsky"] = STEP_BYTES["thermal"]
STEP_FLOPS["thermal_smagorinsky"] = STEP_FLOPS["thermal"] + 27
# bench.py's multiphase row (the droplet) and tests/test_multiphase.py's
# physics gates
MP_NX, MP_NY = 2048, 512
# Mass: the walls and the pull conserve it exactly, but the nine float32
# weights sum to 1 + 2^-27, so at tau = 1 (where a cell's post-collision
# populations are its equilibrium) every step scales the mass by 1 + 2^-27:
# +1.67e-5 over 2239 steps from that term alone, which the plain float32
# step (and tpulbm's float32 tiers) share. The gate holds the relative
# drift from t = 0, less `steps` times that term, within MP_MASS_TOL, and
# the kernel's mass within MP_MASS_VS_PLAIN of the plain step's after the
# same steps.
MP_WEIGHT_EXCESS = float(np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4,
                                  np.float32).astype(np.float64).sum() - 1)
MP_MASS_TOL = 1e-5
MP_MASS_VS_PLAIN = 1e-6


def mass_gate(drift: float, steps: int) -> tuple[bool, str]:
    """(passed, text) of the multiphase mass gate after `steps` steps."""
    excess = drift - steps * MP_WEIGHT_EXCESS
    return abs(excess) < MP_MASS_TOL, (
        f"mass drift {drift:.3e} from t = 0, {excess:.3e} beyond the float32 "
        f"weights' {steps} x {MP_WEIGHT_EXCESS:.3e} (gate {MP_MASS_TOL})")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound(kind: str, cells: int, steps_per_launch: int = 1) -> dict:
    """bound_ms and bound_by for one step of `kind` on `cells` cells; an
    N-step launch moves the state once for N steps."""
    return bound_of(STEP_BYTES[kind], STEP_FLOPS[kind], cells,
                    steps_per_launch)


def bound_of(step_bytes: int, step_flops: int, cells: int,
             steps_per_launch: int = 1) -> dict:
    """bound() for a step of `step_bytes` and `step_flops` a cell."""
    t_bytes = cells * step_bytes / steps_per_launch / HBM_BYTES_PER_S
    t_ops = cells * step_flops / F32_FLOPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers, spill stores and static shared memory of each kernel
    instantiation in a library's ptxas report, as 'kernel<template args>:
    64 regs, 0 B spills'."""
    out, name, spill = [], "?", "?"
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            # the mangled name: a length, then that many characters
            base = "?"
            for m in re.finditer(r"(?=(\d+)[A-Za-z_])", ln):
                start = m.start() + len(m.group(1))
                ident = ln[start:start + int(m.group(1))]
                if ident.endswith("_kernel"):
                    base = ident
                    break
            args = re.findall(r"L[ib](\d+)E", ln)
            name = base + (f"<{','.join(args)}>" if args else "")
        elif "spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name}: {regs} regs, {spill} B spills"
                       + (f", {smem.group(1)} B smem" if smem else ""))
    return "; ".join(out) or log.strip()[-300:]


def initial_state(problem, dev) -> torch.Tensor:
    """The problem's initial state on `dev`, built there where it needs no
    host array (sharded_step.shard_initial_state on one shard, as the
    Runner builds it): the bits of state_from_numpy(problem.initial_state(),
    ...) without a 1.27 GB host array and its copy at 256^3."""
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.parallel.mesh import make_mesh
    mesh = make_mesh((1, 1), devices=[dev])
    return sharded_step.shard_initial_state(problem, mesh)[0][0][0]


def perturbed(problem, f: torch.Tensor) -> torch.Tensor:
    """f times seeded uniform noise in [0.9, 1.1), drawn on f's device,
    with the solid cells (if any) back at rest equilibrium."""
    gen = torch.Generator(device=f.device).manual_seed(PERTURB_SEED)
    out = f * (0.9 + 0.2 * torch.rand(f.shape, generator=gen,
                                      device=f.device, dtype=f.dtype))
    if problem.solid is not None:
        solid = torch.as_tensor(problem.solid, device=f.device)
        w = torch.as_tensor(problem.lattice.w, dtype=f.dtype, device=f.device)
        out = torch.where(solid, w.view(-1, *[1] * solid.ndim), out)
    return out


def separation(label: str, bgk: torch.Tensor, want: torch.Tensor,
               tol: dict) -> float:
    """How many times the tolerance `tol` another library's step `bgk` (the
    BGK library's, the obstacle domain's, the one without the source)
    misses a plain step `want` (at the worst cell); raises below
    SEPARATION."""
    sep = float(((bgk - want).abs()
                 / (tol["atol"] + tol["rtol"] * want.abs())).max())
    require(sep > SEPARATION,
            f"{label}: on the perturbed state the other library's step lies "
            f"{sep:.1f}x the tolerance from the plain step, not "
            f"{SEPARATION}x")
    return sep


def kernel_chunk(step, f: torch.Tensor, n: int) -> torch.Tensor:
    """n launches of `step` (one or N steps each) over ping-pong buffers."""
    spare = torch.empty_like(f)
    for _ in range(n):
        f, spare = step(f, spare), f
    return f


def n_step_tol(n: int) -> dict:
    """N steps against N plain steps: each step adds at most the one-step
    rounding difference (1/rho multiplied in the kernel, divided in the
    plain step), so the one-step tolerance scaled by N."""
    return dict(rtol=n * ONE_STEP_TOL["rtol"], atol=n * ONE_STEP_TOL["atol"])


def same_npz(a: Path, b: Path, skip=()) -> bool:
    """Whether two .npz files hold the same arrays, bit for bit (their zip
    entries carry the time they were written), those named in `skip` (the
    params of fields3d.npz: a run's output directory and mesh) apart."""
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
            for k in x.files if k not in skip)


def same_files(a: Path, b: Path, names) -> bool:
    return all(filecmp.cmp(a / n, b / n, shallow=False) for n in names)


def run_counted(params, dev, keep: str | None = None):
    """One Runner run with every launch count set to 0 just before it;
    returns (result, counts read just after, wall seconds). With `keep`,
    its directory, final state and runner MLUPS are kept in
    ONE_DEVICE_RUNS[keep] for a later phase's mesh run."""
    from tpulbm_torch.runner import Runner

    runner = (CapturingRunner if keep else Runner)(params, device=dev,
                                                    verbose=False)
    reset_counts()
    t0 = time.perf_counter()
    result = runner.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    require(result.success, f"run in {params.output_dir} failed")
    if keep:
        ONE_DEVICE_RUNS[keep] = (Path(params.output_dir),
                                 runner.final_state[0][0], result.mlups)
    return result, counts, wall


def reset_counts() -> None:
    from tpulbm_torch.ops import step_cuda
    step_cuda.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launch count: 1 (D2Q9 1-step), 2-4 (N-step), "3d"
    (D3Q19 1-step), "3d2" and "3d3" (D3Q19 N-step), "thermal",
    "multiphase"."""
    from tpulbm_torch.ops import (step_cuda, step_multiphase_cuda,
                                  step_thermal_cuda)
    return {1: step_cuda.launches(step_cuda.collide_stream),
            **step_cuda.launches(step_cuda.collide_stream_blocked),
            "3d": step_cuda.launches(step_cuda.collide_stream_3d),
            **{f"3d{n}": step_cuda.launches(
                step_cuda.collide_stream_3d_blocked)[n]
               for n in DEPTHS_3D},
            "thermal": step_cuda.launches(
                step_thermal_cuda.collide_stream_thermal),
            "multiphase":
                step_multiphase_cuda.collide_stream_multiphase.launches}


def only(kind, n: int) -> dict:
    """The launch counts of a run that launched `kind` n times and no
    other kernel."""
    counts = {1: 0, 2: 0, 3: 0, 4: 0, "3d": 0, "3d2": 0, "3d3": 0,
              "thermal": 0, "multiphase": 0}
    counts[kind] = n
    return counts


def check_forces(path: Path, steps: list[int]) -> np.ndarray:
    forces = np.loadtxt(path / "forces.csv", delimiter=",", skiprows=1)
    require(forces.shape == (len(steps), 5), f"forces.csv {forces.shape}")
    require(list(forces[:, 0].astype(int)) == steps, "forces.csv timesteps")
    require(bool(np.isfinite(forces).all()), "forces.csv not finite")
    return forces


def plain_chunk(step, f: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        f = step(f)
    return f


def ms_per_step(run, f: torch.Tensor, n: int, warm: int = 20) -> float:
    run(f.clone(), warm)                     # warm-up
    g = f.clone()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g = run(g, n)
    t1.record()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(g).all()), "timed run went non-finite")
    return t0.elapsed_time(t1) / n


def tiny_runner_agreement(dev, label: str = "", fields_rtol: float = 1e-5,
                          **overrides) -> float:
    """The port's Runner through the kernel and through the plain step on
    a 64x32 cylinder (SimulationParams `overrides` on top), 60 steps:
    forces and final fields within rtol 1e-4 / atol 5e-6 and fields_rtol /
    atol 5e-6. The atol covers near-zero values (uy ~ 1e-7) after 60 steps
    of f32 rounding differences between the kernel (1/rho multiplied) and
    the plain step (divided)."""
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.runner import Runner

    out = {}
    for backend in ("pallas", "jax"):
        d = OUT_DIR / f"tiny{label}_{backend}"
        p = SimulationParams(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                             num_timesteps=60, output_frequency=20,
                             precision="f32", backend=backend,
                             enable_vtk=False, output_dir=str(d),
                             **overrides)
        require(Runner(p, device=dev, verbose=False).run().success,
                f"tiny run ({backend}) failed")
        out[backend] = (np.loadtxt(d / "forces.csv", delimiter=",",
                                   skiprows=1),
                        np.loadtxt(d / "velocity_field.csv", delimiter=",",
                                   skiprows=1))
    (fk, vk), (fp, vp) = out["pallas"], out["jax"]
    np.testing.assert_allclose(fk[:, 1:3], fp[:, 1:3], rtol=1e-4, atol=5e-6)
    np.testing.assert_allclose(vk, vp, rtol=fields_rtol, atol=5e-6)
    return float(np.abs(fk[:, 1:3] - fp[:, 1:3]).max())


def sphere_phases(dev, card: str) -> list[dict]:
    """Phases 6-8: the D3Q19 kernels at 256^3 against the plain step and
    each other, the 3-D main path through the Runner, and timing. Returns
    the kernels' JSON entries."""
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda, step_torch
    from tpulbm_torch.stepper import make_chunk_fn

    # phase 6: parity at bench.py's d3q19 row
    n = SPHERE_N
    params = SimulationParams(problem="cylinder3d", nx=n, ny=n, nz=n,
                              inlet_velocity=0.05, precision="f32",
                              enable_vtk=False)
    problem = make_problem(params)
    kstep = step_cuda.make_local_step_cuda_3d(problem, dev)
    pstep = step_torch.make_step_rolled(problem, dev)
    f0 = initial_state(problem, dev)
    f100 = plain_chunk(pstep, f0.clone(), 100)

    def one_step_err(f: torch.Tensor) -> float:
        got = kstep(f, torch.empty_like(f))
        want = pstep(f)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **ONE_STEP_TOL)
        return float((got - want).abs().max())

    err_init = one_step_err(f0)
    err_100 = one_step_err(f100)
    print(f"3-D parity 1 step at {n}^3: max abs err {err_init:.3e} from the "
          f"initial state, {err_100:.3e} after 100 plain steps (rtol 5e-6, "
          f"atol 1e-7)")
    fk = kernel_chunk(kstep, f0.clone(), 280)
    fp = plain_chunk(pstep, f0.clone(), 280)
    torch.cuda.synchronize()
    err_280 = float((fk - fp).abs().max())
    require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
            f"3-D 280-step drift {err_280} beyond {DRIFT_280_BOUND}")
    print(f"3-D parity 280 steps: max abs err {err_280:.3e} "
          f"(bound {DRIFT_280_BOUND})")
    del fp

    # phase 6b: the N-step kernel against N 1-step launches and N plain
    # steps, then 280 steps as tpulbm's plan against 280 1-step launches
    bsteps = {d: step_cuda.make_local_step_cuda_3d_blocked(problem, dev, d)
              for d in DEPTHS_3D}
    err_plain = {}
    for d in DEPTHS_3D:
        errs = []
        for name, f in (("initial", f0), ("100 plain steps", f100)):
            got = bsteps[d](f, torch.empty_like(f))
            want = kernel_chunk(kstep, f.clone(), d)
            want_plain = plain_chunk(pstep, f.clone(), d)
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            require(diff == 0.0 and torch.equal(got, want),
                    f"3-D N={d} from {name}: {diff} off {d} 1-step launches")
            torch.testing.assert_close(got, want_plain, **n_step_tol(d))
            errs.append(float((got - want_plain).abs().max()))
        err_plain[d] = max(errs)
        print(f"3-D parity N={d}: max abs diff 0.0 against {d} 1-step "
              f"launches from both states (bitwise); against {d} plain steps "
              f"{errs[0]:.3e} / {errs[1]:.3e} (rtol "
              f"{n_step_tol(d)['rtol']:.0e}, atol {n_step_tol(d)['atol']:.0e})")
    del got, want, want_plain, f100
    chunk = make_chunk_fn(problem, dev, 280)
    require(chunk.plan == [(3, 92), (2, 2)], f"280-step plan {chunk.plan}")
    fb = chunk(f0.clone())
    torch.cuda.synchronize()
    diff_280 = float((fb - fk).abs().max())
    require(diff_280 == 0.0 and torch.equal(fb, fk),
            f"280 steps as {chunk.plan}: {diff_280} off 280 1-step launches")
    print(f"3-D parity 280 steps: the plan {chunk.plan} equals 280 1-step "
          f"launches (max abs diff 0.0)")
    del fk, fb
    torch.cuda.empty_cache()

    # phase 7: the 3-D main path through tpulbm's plan, counted, then the
    # same run with blocking off
    run_dir = OUT_DIR / f"sphere{n}"
    main_params = params.replace(num_timesteps=2240, output_frequency=140,
                                 output_dir=str(run_dir))
    runner = CapturingRunner(main_params, device=dev, verbose=False)
    reset_counts()
    t0 = time.perf_counter()
    result = runner.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    require(result.success, f"run in {run_dir} failed")
    # the one-device run that phase 52's 2x2 mesh is held to
    ONE_DEVICE_RUNS["sphere256"] = (run_dir, runner.final_state[0][0],
                                    result.mlups)
    del runner
    require(counts == {**only("3d3", 735), "3d2": 17, "3d": 1},
            f"launch counts {counts}, not 735 N=3, 17 N=2, 1 one-step "
            "D3Q19 and 0 others")
    forces = check_forces(run_dir, list(range(0, 2240, 140)))
    with np.load(run_dir / "fields3d.npz") as fields:
        for name in ("rho", "ux", "uy", "uz"):
            require(fields[name].shape == (n, n, n),
                    f"fields3d.npz {name} {fields[name].shape}")
            require(bool(np.isfinite(fields[name]).all()),
                    f"fields3d.npz {name} not finite")
    print(f"3-D main path: sphere {n}^3 f32, 2240 steps, launches "
          f"{counts['3d3']} N=3 + {counts['3d2']} N=2 + {counts['3d']} "
          f"one-step D3Q19 (D2Q9: {counts[1]} 1-step, N=2/3/4 "
          f"{counts[2]}/{counts[3]}/{counts[4]}), {result.host_fetches} host "
          f"fetches in the loop, {wall:.2f} s wall, runner "
          f"{result.mlups:.1f} MLUPS, final C_D {forces[-1, 3]:.6f}")
    d1 = OUT_DIR / f"sphere{n}_unblocked"
    os.environ["TPULBM_NO_FUSED2"] = "1"
    try:
        res1, counts1, wall1 = run_counted(
            main_params.replace(output_dir=str(d1)), dev)
    finally:
        del os.environ["TPULBM_NO_FUSED2"]
    require(counts1 == only("3d", 2240),
            f"unblocked launch counts {counts1}, not 2240 one-step D3Q19")
    forces1 = check_forces(d1, list(range(0, 2240, 140)))
    np.testing.assert_array_equal(forces[:, 0], forces1[:, 0])
    np.testing.assert_allclose(forces[:, 1:3], forces1[:, 1:3], **FORCES_TOL)
    q = 0.5 * params.inlet_velocity ** 2 * np.pi \
        * params.get_cylinder_radius_cells() ** 2
    np.testing.assert_allclose(forces[:, 3:5], forces1[:, 3:5],
                               rtol=FORCES_TOL["rtol"],
                               atol=FORCES_TOL["atol"] / q)
    field_diff = 0.0
    with np.load(run_dir / "fields3d.npz") as a, \
            np.load(d1 / "fields3d.npz") as b:
        for name in ("rho", "ux", "uy", "uz"):
            np.testing.assert_allclose(a[name], b[name], err_msg=name,
                                       **FIELDS_TOL)
            field_diff = max(field_diff,
                             float(np.abs(a[name] - b[name]).max()))
    same = same_files(run_dir, d1, ["forces.csv"])
    print(f"3-D main path with blocking off: {counts1['3d']} one-step "
          f"launches, {wall1:.2f} s wall, runner {res1.mlups:.1f} MLUPS; "
          f"forces max abs diff {float(np.abs(forces - forces1).max()):.3e}"
          f" (forces.csv byte-identical: {same}), fields3d.npz max abs diff "
          f"{field_diff:.3e} (rtol 1e-5, atol 5e-6)")

    # phase 8: timing in turns; the plain step is host-bound (~350
    # launches a step), so PLAIN_3D_STEPS steps a turn; ms per step (a
    # launch is N)
    runs = {"plain": (lambda f, m: plain_chunk(pstep, f, m), PLAIN_3D_STEPS),
            1: (lambda f, m: kernel_chunk(kstep, f, m), 500)}
    for d in DEPTHS_3D:
        runs[d] = (lambda f, m, d=d: kernel_chunk(bsteps[d], f, m // d),
                   500 // d * d)
    order = ["plain", 1, *DEPTHS_3D]
    times = {k: [] for k in order}
    for which in order + order[::-1]:
        run, steps = runs[which]
        times[which].append(ms_per_step(run, f0, steps, PLAIN_WARM
                                        if which == "plain" else 20))
    ms = {k: min(v) for k, v in times.items()}
    cells = n ** 3
    b = {d: bound("d3q19", cells, d) for d in (1, *DEPTHS_3D)}
    print(f"3-D timing at {n}^3 on {card}, ms/step (MLUPS): plain "
          f"{ms['plain']:.5f} ({cells / ms['plain'] / 1e3:.1f}, runs "
          f"{[round(v, 6) for v in times['plain']]}); "
          + "; ".join(
              f"{'1-step' if d == 1 else f'N={d}'} {ms[d]:.5f} "
              f"({cells / ms[d] / 1e3:.1f}, runs "
              f"{[round(v, 6) for v in times[d]]}), "
              f"{BYTES_3D / d / (ms[d] * 1e-3) / 1e9:.1f} GB/s, "
              f"{100 * b[d]['bound_ms'] / ms[d]:.1f}% of its bound "
              f"{b[d]['bound_ms']:.5f} ms" for d in (1, *DEPTHS_3D)))
    del f0
    torch.cuda.empty_cache()
    entries = [{"name": "d3q19_collide_stream", "route": "cuda",
                "source": step_cuda.SOURCE_3D,
                "replaces": step_cuda.REPLACES_3D,
                "launches": counts["3d"],
                "max_abs_err": max(err_init, err_100),
                "ms": ms[1], "plain_ms": ms["plain"], **b[1]}]
    for d in DEPTHS_3D:
        entries.append({
            "name": f"d3q19_collide_stream_n{d}", "route": "cuda",
            "source": step_cuda.SOURCE_3D_BLOCKED,
            "replaces": step_cuda.REPLACES_3D_BLOCKED,
            "launches": counts[f"3d{d}"], "max_abs_err": err_plain[d],
            "ms": ms[d], "plain_ms": ms["plain"], **b[d]})
    return entries


def thermal_params(problem: str, nx: int, ny: int, **kw):
    """bench.py's thermal row (Ra 1e4, tau 0.55, thermal_tau 0.5704) for
    `problem` on an nx x ny grid, f32, no VTK."""
    from tpulbm_torch.config import SimulationParams
    return SimulationParams(problem=problem, nx=nx, ny=ny, tau=0.55,
                            thermal_tau=0.5704, rayleigh=1e4,
                            inlet_velocity=0.0, cylinder_radius=0.0,
                            periodic_x=problem == "rayleigh-benard",
                            precision="f32", enable_vtk=False, **kw)


def thermal_parity(dev, name: str, nx: int, ny: int, **kw):
    """Phase 9 (24 with the closure's Cs in kw) on one grid: one kernel
    step against one plain step from the initial state and after 500 plain
    steps, then 280 steps of each. Returns (the larger one-step error, the
    kernel and plain steps and the initial state)."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_thermal, step_thermal_cuda

    problem = make_problem(thermal_params(name, nx, ny, **kw))
    kstep = step_thermal_cuda.make_local_step_thermal_cuda(problem, dev)
    pstep = step_thermal.make_step_thermal(problem, dev)
    s0 = initial_state(problem, dev)
    errs = []
    for s in (s0, plain_chunk(pstep, s0.clone(), 500)):
        got = kstep(s, torch.empty_like(s))
        want = pstep(s)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **ONE_STEP_TOL)
        errs.append(float((got - want).abs().max()))
    sk = kernel_chunk(kstep, s0.clone(), 280)
    sp = plain_chunk(pstep, s0.clone(), 280)
    torch.cuda.synchronize()
    err_280 = float((sk - sp).abs().max())
    require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
            f"thermal {name} {nx}x{ny} 280-step drift {err_280} beyond "
            f"{DRIFT_280_BOUND}")
    print(f"thermal parity {name} {nx}x{ny}{f' {kw}' if kw else ''}: 1 step "
          f"max abs err "
          f"{errs[0]:.3e} from the initial state, {errs[1]:.3e} after 500 "
          f"plain steps (rtol 5e-6, atol 1e-7); 280 steps {err_280:.3e} "
          f"(bound {DRIFT_280_BOUND})")
    return max(errs), kstep, pstep, s0


def final_nusselt(run_dir: Path, rows: list[int]) -> np.ndarray:
    nu = np.loadtxt(run_dir / "nusselt.csv", delimiter=",", skiprows=1,
                    ndmin=2)
    require(nu.shape == (len(rows), 2), f"nusselt.csv {nu.shape}")
    require(list(nu[:, 0].astype(int)) == rows, "nusselt.csv timesteps")
    require(bool(np.isfinite(nu).all()), "nusselt.csv not finite")
    require(not (run_dir / "forces.csv").exists(),
            "a thermal run wrote forces.csv")
    return nu


def thermal_phases(dev, card: str) -> dict:
    """Phases 9-12: the thermal kernel against the plain thermal step, the
    thermal main path through the Runner, the physics gates and timing.
    Returns the kernel's JSON entry."""
    from tpulbm_torch.config import PRESETS
    from tpulbm_torch.ops import step_thermal_cuda

    # phase 9: parity at the main path's shape, the cavity's, a ragged one
    err, kstep, pstep, s0 = thermal_parity(dev, "rayleigh-benard",
                                           THERMAL_NX, THERMAL_NY)
    for name, nx, ny in (("heated-cavity", 96, 96),
                         ("rayleigh-benard", 100, 70),
                         ("heated-cavity", 100, 70)):
        thermal_parity(dev, name, nx, ny)

    # phase 10: the thermal main path, counted
    nx, ny = THERMAL_NX, THERMAL_NY
    run_dir = OUT_DIR / "rayleigh_benard_2048x512"
    params = thermal_params("rayleigh-benard", nx, ny, num_timesteps=2240,
                            output_frequency=140, output_dir=str(run_dir))
    # held to by phase 57's 2x2 mesh
    result, counts, wall = run_counted(params, dev, keep="rb2048")
    require(counts == only("thermal", 2240),
            f"launch counts {counts}, not 2240 thermal and 0 others")
    nu = final_nusselt(run_dir, list(range(0, 2240, 140)))
    temp = np.loadtxt(run_dir / "temperature_field.csv", delimiter=",",
                      skiprows=1)
    require(temp.shape == (nx * ny, 3),
            f"temperature_field.csv shape {temp.shape}")
    require(bool(np.isfinite(temp).all()), "temperature_field.csv not finite")
    print(f"thermal main path: rayleigh-benard {nx}x{ny} f32 Ra 1e4, 2240 "
          f"steps, launches {counts['thermal']} thermal (D2Q9 {counts[1]} "
          f"1-step, N=2/3/4 {counts[2]}/{counts[3]}/{counts[4]}; D3Q19 "
          f"{counts['3d']}), {result.host_fetches} host fetches in the loop, "
          f"{wall:.2f} s wall, runner {result.mlups:.1f} MLUPS, Nu at "
          f"t=2100 {nu[-1, 1]:.6f}, final Nu {result.stats['nusselt']:.6f}")

    # phase 11: the physics gates through the Runner (the presets' own
    # depth and cadence)
    gates = {"heated-cavity": lambda v: abs(v - DE_VAHL_DAVIS_NU)
             / DE_VAHL_DAVIS_NU < 0.03,
             "rayleigh-benard": lambda v: 2.0 < v < 3.0}
    for name, gate in gates.items():
        preset = PRESETS[name]
        d = OUT_DIR / f"{name}_preset"
        res, c, w = run_counted(preset.replace(output_dir=str(d)), dev)
        final_nusselt(d, list(range(0, preset.num_timesteps,
                                    preset.output_frequency)))
        v = res.stats["nusselt"]
        print(f"thermal physics: {name} preset {preset.nx}x{preset.ny}, "
              f"{preset.num_timesteps} steps ({c['thermal']} thermal "
              f"launches, {w:.2f} s wall, runner {res.mlups:.1f} MLUPS): "
              f"final Nu {v:.6f}"
              + (f" ({100 * (v / DE_VAHL_DAVIS_NU - 1):+.2f}% from de Vahl "
                 f"Davis's {DE_VAHL_DAVIS_NU})" if name == "heated-cavity"
                 else " (gate 2 < Nu < 3)"))
        require(c["thermal"] == preset.num_timesteps and gate(v),
                f"{name} preset: Nu {v}, {c['thermal']} launches")

    # phase 12: timing in turns; the plain step is host-bound, so fewer
    # steps a turn
    runs = {"plain": (lambda f, n: plain_chunk(pstep, f, n),
                      PLAIN_2D_STEPS),
            "kernel": (lambda f, n: kernel_chunk(kstep, f, n), 2400)}
    times = {k: [] for k in runs}
    for which in ["plain", "kernel", "kernel", "plain"]:
        run, steps = runs[which]
        times[which].append(ms_per_step(run, s0, steps, PLAIN_WARM
                                        if which == "plain" else 20))
    ms = {k: min(v) for k, v in times.items()}
    cells = nx * ny
    bw = cells * STEP_BYTES["thermal"] / (ms["kernel"] * 1e-3)
    print(f"thermal timing at {nx}x{ny} on {card}, ms/step (MLUPS): plain "
          f"{ms['plain']:.5f} ({cells / ms['plain'] / 1e3:.1f}, runs "
          f"{[round(v, 6) for v in times['plain']]}); kernel "
          f"{ms['kernel']:.5f} ({cells / ms['kernel'] / 1e3:.1f}, runs "
          f"{[round(v, 6) for v in times['kernel']]}); kernel "
          f"{bw / 1e9:.1f} GB/s, {100 * bw / HBM_BYTES_PER_S:.1f}% of "
          f"3.35 TB/s at {STEP_BYTES['thermal']} B/cell")
    return {"name": "thermal_collide_stream", "route": "cuda",
            "source": step_thermal_cuda.SOURCE,
            "replaces": step_thermal_cuda.REPLACES,
            "launches": counts["thermal"], "max_abs_err": err,
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            **bound("thermal", cells)}


def mp_params(nx: int, ny: int, **kw):
    """bench.py's multiphase row (g -5, tau 1.0, a droplet of radius
    0.15 ny at the centre) on an nx x ny grid, f32, no VTK; kw overrides."""
    from tpulbm_torch.config import SimulationParams
    d = dict(problem="multiphase", nx=nx, ny=ny, tau=1.0, shan_chen_g=-5.0,
             inlet_velocity=0.0, cylinder_radius=0.15, cylinder_x=0.5,
             cylinder_y=0.5, precision="f32", enable_vtk=False)
    d.update(kw)
    return SimulationParams(**d)


def mp_parity(dev, label: str, params):
    """Phase 13 on one grid: one kernel step against one plain multiphase
    step from the initial state and after 500 plain steps. Returns (the
    larger error, the problem, the kernel and plain steps, the initial
    state)."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_multiphase, step_multiphase_cuda

    problem = make_problem(params)
    kstep = step_multiphase_cuda.make_local_step_multiphase_cuda(problem, dev)
    pstep = step_multiphase.make_step_multiphase(problem, dev)
    f0 = initial_state(problem, dev)
    errs = []
    for f in (f0, plain_chunk(pstep, f0.clone(), 500)):
        got = kstep(f, torch.empty_like(f))
        want = pstep(f)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **ONE_STEP_TOL)
        errs.append(float((got - want).abs().max()))
    print(f"multiphase parity {label} {params.nx}x{params.ny}: 1 step max "
          f"abs err {errs[0]:.3e} from the initial state, {errs[1]:.3e} "
          f"after 500 plain steps (rtol 5e-6, atol 1e-7)")
    return max(errs), problem, kstep, pstep, f0


def mp_run(dev, params, steps: int) -> tuple[np.ndarray, float, int]:
    """`steps` steps of a multiphase problem from its initial state through
    the kernel, as the Runner's chunks make them. Returns (rho summed in
    float64, relative mass drift, kernel launches)."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.stepper import make_chunk_fn

    problem = make_problem(params)
    f = initial_state(problem, dev)
    mass0 = float(f.double().sum())
    reset_counts()
    f = make_chunk_fn(problem, dev, steps, backend="pallas")(f)
    launches = read_counts()["multiphase"]
    rho = f.double().sum(0)
    require(bool(torch.isfinite(rho).all()), "multiphase run not finite")
    drift = (float(rho.sum()) - mass0) / mass0
    return rho.cpu().numpy(), drift, launches


def mp_physics(dev) -> None:
    """Phase 15: tests/test_multiphase.py's physics gates with the kernel
    in f32 at its sizes and thresholds."""
    from tpulbm_torch import physics

    # phase separation: the 64x32 band, 2000 steps
    rho, drift, n = mp_run(dev, mp_params(64, 32, cylinder_radius=0.0), 2000)
    ratio = rho.max() / rho.min()
    liq = rho[rho.shape[0] // 2][28:36]
    flat = liq.std() / liq.mean()
    mass_ok, mass_text = mass_gate(drift, n)
    print(f"multiphase physics: band 64x32, 2000 steps ({n} launches): "
          f"rho_max/rho_min {ratio:.6f} (gate > 5), liquid interior "
          f"std/mean {flat:.3e} (gate < 0.01), {mass_text}")
    require(n == 2000 and ratio > 5.0 and flat < 0.01 and mass_ok,
            "phase separation gate failed")

    # the Laplace law: ΔP = σ/R from two droplet radii
    def laplace(frac: float, n_xy: int = 80, steps: int = 6000):
        rho, _, n = mp_run(dev, mp_params(n_xy, n_xy, cylinder_radius=frac),
                           steps)
        require(n == steps, f"Laplace run: {n} launches")
        P = physics.shan_chen_pressure(torch.from_numpy(rho), -5.0).numpy()
        c = n_xy // 2
        p_in = P[c - 1:c + 2, c - 1:c + 2].mean()
        # far field at mid-height near the periodic x edges (the phantom
        # rho = 1 walls wet partially, so corners overestimate it)
        p_out = np.concatenate([P[c - 1:c + 2, 1:4].ravel(),
                                P[c - 1:c + 2, -4:-1].ravel()]).mean()
        cut = 0.5 * (rho.max() + rho.min())
        return p_in - p_out, float(np.sqrt((rho > cut).sum() / np.pi))

    (dp1, r1), (dp2, r2) = laplace(0.12), laplace(0.20)
    s1, s2 = dp1 * r1, dp2 * r2
    spread = abs(s1 - s2) / max(s1, s2)
    print(f"multiphase physics: Laplace law 80x80, 6000 steps each: R1 "
          f"{r1:.4f} dP1 {dp1:.6e} sigma1 {s1:.6e}; R2 {r2:.4f} dP2 "
          f"{dp2:.6e} sigma2 {s2:.6e}; sigma spread {100 * spread:.2f}% "
          f"(gate 20%)")
    require(dp1 > 0 and dp2 > 0 and r2 > r1 > 3.0 and spread < 0.20,
            "Laplace-law gate failed")

    # wettability: the spread width one row off the wall orders with the
    # wall density
    widths = {}
    for wall in (1.6, 1.0, 0.16):
        rho, _, n = mp_run(dev, mp_params(96, 48, cylinder_radius=0.25,
                                          cylinder_y=0.0, mp_wall_rho=wall),
                           4000)
        require(n == 4000, f"wettability run: {n} launches")
        cut = 0.5 * (rho.max() + rho.min())
        widths[wall] = int((rho[1] > cut).sum())
    print(f"multiphase physics: wettability 96x48, 4000 steps each: spread "
          f"width at wall rho 1.6 / 1.0 / 0.16: {widths[1.6]} / "
          f"{widths[1.0]} / {widths[0.16]} (gate strictly decreasing)")
    require(widths[1.6] > widths[1.0] > widths[0.16],
            "wettability gate failed")


def multiphase_phases(dev, card: str) -> dict:
    """Phases 13-16: the multiphase kernel against the plain step, the
    multiphase main path through the Runner, the physics gates and
    timing. Returns the kernel's JSON entry."""
    from tpulbm_torch import physics
    from tpulbm_torch.ops import diagnostics, step_multiphase_cuda

    # phase 13: parity at the main path's shape, the band with a wetting
    # wall, two ragged grids; 280 steps at the main path's shape
    t_phases = time.perf_counter()
    nx, ny = MP_NX, MP_NY
    err, problem, kstep, pstep, f0 = mp_parity(dev, "droplet",
                                               mp_params(nx, ny))
    for label, p in (("band, wall rho 1.6",
                      mp_params(64, 32, cylinder_radius=0.0,
                                mp_wall_rho=1.6)),
                     ("droplet", mp_params(7, 3, cylinder_radius=0.3)),
                     ("droplet", mp_params(100, 70))):
        err = max(err, mp_parity(dev, label, p)[0])
    fk = kernel_chunk(kstep, f0.clone(), 280)
    fp = plain_chunk(pstep, f0.clone(), 280)
    torch.cuda.synchronize()
    err_280 = float((fk - fp).abs().max())
    require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
            f"multiphase 280-step drift {err_280} beyond {DRIFT_280_BOUND}")
    print(f"multiphase parity 280 steps at {nx}x{ny}: max abs err "
          f"{err_280:.3e} (bound {DRIFT_280_BOUND})")
    del fk, fp

    # phase 14: the multiphase main path, counted
    run_dir = OUT_DIR / "multiphase_2048x512"
    params = mp_params(nx, ny, num_timesteps=2240, output_frequency=140,
                       output_dir=str(run_dir))
    # held to by phase 59's (4,1) mesh
    result, counts, wall = run_counted(params, dev, keep="mp2048")
    require(counts == only("multiphase", 2240),
            f"launch counts {counts}, not 2240 multiphase and 0 others")
    require(not (run_dir / "forces.csv").exists(),
            "a multiphase run wrote forces.csv")
    field = np.loadtxt(run_dir / "velocity_field.csv", delimiter=",",
                       skiprows=1)
    require(field.shape == (nx * ny, 6),
            f"velocity_field.csv shape {field.shape}")
    require(bool(np.isfinite(field).all()), "velocity_field.csv not finite")
    # the file holds the fields one step before the end: the physical
    # velocity u + F/(2 rho) of the state after 2239 kernel steps (the
    # same launches as the Runner's, so the same bits), to the CSV's 8
    # decimals, and not the bare moments
    f_end = kernel_chunk(kstep, f0.clone(), 2239)
    rho_p, u_p = diagnostics.fields_fn(problem, dev)(f_end)
    want = np.stack([u_p[0].cpu().numpy().ravel(),
                     u_p[1].cpu().numpy().ravel(),
                     rho_p.cpu().numpy().ravel()], axis=1)
    csv_err = float(np.abs(field[:, 2:5] - want).max())
    require(csv_err < 1e-8, f"velocity_field.csv {csv_err} off the "
            "physical velocity")
    _, u_bare = physics.moments(problem.lattice, f_end)
    shift = float(np.abs(field[:, 2] - u_bare[0].cpu().numpy().ravel())
                  .max())
    require(shift > 1e-6, f"velocity_field.csv carries the bare moments "
            f"(max |u - u_bare| {shift})")
    mass0 = float(f0.double().sum())
    mass = float(field[:, 4].sum())
    mass_plain = float(plain_chunk(pstep, f0.clone(), 2239).double().sum())
    mass_ok, mass_text = mass_gate((mass - mass0) / mass0, 2239)
    vs_plain = abs(mass - mass_plain) / mass0
    require(mass_ok and vs_plain < MP_MASS_VS_PLAIN,
            f"{mass_text}; {vs_plain} off the plain step's")
    print(f"multiphase main path: droplet {nx}x{ny} f32, 2240 steps, "
          f"launches {counts['multiphase']} multiphase (others: "
          f"{sum(counts.values()) - counts['multiphase']}), "
          f"{result.host_fetches} host fetches in the loop, {wall:.2f} s "
          f"wall, runner {result.mlups:.1f} MLUPS; velocity_field.csv "
          f"{csv_err:.3e} off the physical velocity (max |F/(2 rho)| "
          f"{shift:.3e}); {mass_text}, {vs_plain:.3e} off the plain "
          f"step's after 2239 steps (gate {MP_MASS_VS_PLAIN})")
    del f_end, u_bare

    # phase 15: the physics gates
    t0 = time.perf_counter()
    mp_physics(dev)
    print(f"multiphase physics: gates passed in "
          f"{time.perf_counter() - t0:.2f} s")

    # phase 16: timing in turns; the plain step is host-bound
    runs = {"plain": (lambda f, n: plain_chunk(pstep, f, n),
                      PLAIN_2D_STEPS),
            "kernel": (lambda f, n: kernel_chunk(kstep, f, n), 2400)}
    times = {k: [] for k in runs}
    for which in ["plain", "kernel", "kernel", "plain"]:
        run, steps = runs[which]
        times[which].append(ms_per_step(run, f0, steps, PLAIN_WARM
                                        if which == "plain" else 20))
    ms = {k: min(v) for k, v in times.items()}
    cells = nx * ny
    b = bound("multiphase", cells)
    bw = cells * STEP_BYTES["multiphase"] / (ms["kernel"] * 1e-3)
    print(f"multiphase timing at {nx}x{ny} on {card}, ms/step (MLUPS): "
          f"plain {ms['plain']:.5f} ({cells / ms['plain'] / 1e3:.1f}, runs "
          f"{[round(v, 6) for v in times['plain']]}); kernel "
          f"{ms['kernel']:.5f} ({cells / ms['kernel'] / 1e3:.1f}, runs "
          f"{[round(v, 6) for v in times['kernel']]}); kernel "
          f"{bw / 1e9:.1f} GB/s, {100 * b['bound_ms'] / ms['kernel']:.1f}% "
          f"of its bound {b['bound_ms']:.5f} ms at "
          f"{STEP_BYTES['multiphase']} B/cell")
    del f0
    torch.cuda.empty_cache()
    print(f"multiphase phases 13-16: {time.perf_counter() - t_phases:.2f} s")
    return {"name": "multiphase_collide_stream", "route": "cuda",
            "source": step_multiphase_cuda.SOURCE,
            "replaces": step_multiphase_cuda.REPLACES,
            "launches": counts["multiphase"], "max_abs_err": err,
            "ms": ms["kernel"], "plain_ms": ms["plain"], **b}

def close_or_relative(got: torch.Tensor, want: torch.Tensor, tol: dict,
                      relative: bool) -> str:
    """Hold got to want at tol; where that fails and `relative` is set (KBC),
    at max|d|/max|f| < KBC_REL_TOL instead. Returns which held."""
    try:
        torch.testing.assert_close(got, want, **tol)
        return f"rtol {tol['rtol']:.0e} / atol {tol['atol']:.0e}"
    except AssertionError:
        if not relative:
            raise
    rel = float((got - want).abs().max() / want.abs().max())
    require(rel < KBC_REL_TOL, f"max|d|/max|f| {rel} beyond {KBC_REL_TOL}")
    return f"max|d|/max|f| {rel:.3e} < {KBC_REL_TOL}"


def operator_parity(dev, op: str):
    """Phase 17 for one operator at 2048x512: one 1-step kernel step
    against one plain step from the initial state and after 500 plain
    steps; 280 kernel steps against 280 plain steps; the N-step kernel at
    N = 2, 3, 4 bitwise against N 1-step launches and within N times the
    one-step tolerance of N plain steps, from both states. Returns (the
    params, the collision mode, the kernel steps by depth, the plain step,
    the initial state, the errors against the plain step by depth)."""
    from tpulbm_torch.config import PRESETS
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda, step_torch

    params = PRESETS["re200"].replace(precision="f32", enable_vtk=False,
                                      **OPERATORS[op])
    problem = make_problem(params)
    tol = PLAW_TOL if op == "power_law" else ONE_STEP_TOL
    relative = op == "kbc"
    steps = {1: step_cuda.make_local_step_cuda(problem, dev)}
    for n in DEPTHS:
        steps[n] = step_cuda.make_local_step_cuda_blocked(problem, dev, n)
    pstep = step_torch.make_step_rolled(problem, dev)
    f0 = initial_state(problem, dev)
    f500 = plain_chunk(pstep, f0.clone(), 500)
    errs, held = [], []
    for f in (f0, f500):
        got = steps[1](f, torch.empty_like(f))
        want = pstep(f)
        torch.cuda.synchronize()
        held.append(close_or_relative(got, want, tol, relative))
        errs.append(float((got - want).abs().max()))
    fk = kernel_chunk(steps[1], f0.clone(), 280)
    fp = plain_chunk(pstep, f0.clone(), 280)
    torch.cuda.synchronize()
    err_280 = float((fk - fp).abs().max())
    require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
            f"{op}: 280-step drift {err_280} beyond {DRIFT_280_BOUND}")
    del fk, fp
    err_n = {}
    for n in DEPTHS:
        errs_n = []
        for name, f in (("initial", f0), ("500 plain steps", f500)):
            got = steps[n](f, torch.empty_like(f))
            want = kernel_chunk(steps[1], f.clone(), n)
            want_plain = plain_chunk(pstep, f.clone(), n)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"{op} N={n} from {name}: "
                    f"{float((got - want).abs().max())} off {n} 1-step "
                    "launches")
            close_or_relative(got, want_plain,
                              dict(rtol=n * tol["rtol"], atol=n * tol["atol"]),
                              relative)
            errs_n.append(float((got - want_plain).abs().max()))
        err_n[n] = max(errs_n)
    mode = step_torch.collision_mode(problem)
    print(f"operator parity {op} ({mode}, "
          f"{OPERATORS[op]}) at {params.nx}x{params.ny}: 1 step max abs err "
          f"{errs[0]:.3e} from the initial state ({held[0]} held), "
          f"{errs[1]:.3e} after 500 plain steps ({held[1]} held); 280 steps "
          f"{err_280:.3e} (bound {DRIFT_280_BOUND}); N=2/3/4 bitwise against "
          f"N 1-step launches from both states, against N plain steps "
          + "/".join(f"{err_n[n]:.3e}" for n in DEPTHS))
    return params, mode, steps, pstep, f0, {1: max(errs), **err_n}


def operator_main_path(dev, op: str, params, mode: str) -> dict:
    """Phase 18 for one operator: the Runner at 2048x512, 2240 steps every
    140, no VTK, counted: exactly 525 N=4 and 140 1-step launches of the
    operator's libraries and none of another kernel; 16 finite force rows
    and a finite velocity field. Then phase 4c's 311-step run (100 N=3, 5
    N=2, 1 1-step launches), byte-identical to the same run with blocking
    off. Returns the launch counts by depth: 1-step and N=4 from the
    first run, N=2 and N=3 from the second."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.runner import Runner

    run_dir = OUT_DIR / f"re200_{op}"
    result, counts, wall = run_counted(
        params.replace(num_timesteps=2240, output_frequency=140,
                       output_dir=str(run_dir)), dev)
    one = step_cuda.launches_by_mode(step_cuda.collide_stream)
    blocked = step_cuda.launches_by_mode(step_cuda.collide_stream_blocked)
    by_mode = (one[mode], blocked[mode][4])
    require(counts == {**only(4, 525), 1: 140} and by_mode == (140, 525),
            f"{op}: launch counts {counts} ({by_mode} of {mode}), not 525 "
            "N=4, 140 1-step and 0 others")
    forces = check_forces(run_dir, list(range(0, 2240, 140)))
    # the 1M-row field, checked as text: every row there and no nan or inf
    text = (run_dir / "velocity_field.csv").read_bytes().lower()
    require(text.count(b"\n") == params.nx * params.ny + 1
            and b"nan" not in text and b"inf" not in text,
            f"{op}: velocity_field.csv not a finite {params.nx * params.ny}"
            "-row field")
    print(f"operator main path {op}: re200 {params.nx}x{params.ny} f32, 2240 "
          f"steps, launches {counts[4]} N=4 + {counts[1]} 1-step of {mode} "
          f"(N=2: {counts[2]}, N=3: {counts[3]}), {result.host_fetches} host "
          f"fetches in the loop, {wall:.2f} s wall, runner "
          f"{result.mlups:.1f} MLUPS, final C_D {forces[-1, 3]:.6f}")
    # phase 4c's run for the other depths: 311 steps every 150, against
    # the same run with blocking off
    d23 = OUT_DIR / f"re200_f150_{op}"
    p23 = params.replace(num_timesteps=311, output_frequency=150,
                         output_dir=str(d23))
    _, counts23, _ = run_counted(p23, dev)
    one = step_cuda.launches_by_mode(step_cuda.collide_stream)
    blocked = step_cuda.launches_by_mode(step_cuda.collide_stream_blocked)
    by_mode = (one[mode], *(blocked[mode][n] for n in (2, 3)))
    require(counts23 == {**only(3, 100), 1: 1, 2: 5}
            and by_mode == (1, 5, 100),
            f"{op}: launch counts {counts23} ({by_mode} of {mode}), not 100 "
            "N=3, 5 N=2, 1 1-step")
    d1 = OUT_DIR / f"re200_f150_{op}_unblocked"
    os.environ["TPULBM_NO_FUSED2"] = "1"
    try:
        require(Runner(p23.replace(output_dir=str(d1)), device=dev,
                       verbose=False).run().success, "unblocked run failed")
    finally:
        del os.environ["TPULBM_NO_FUSED2"]
    require(same_files(d23, d1, ["forces.csv", "velocity_field.csv"]),
            f"{op}: the N=3/N=2 run differs from the 1-step-only run")
    print(f"operator depths 3 and 2 {op}: 311 steps every 150, launches "
          f"{counts23[3]} N=3 + {counts23[2]} N=2 + {counts23[1]} 1-step; "
          "artifacts byte-identical to the 1-step-only run")
    return {1: counts[1], 2: counts23[2], 3: counts23[3], 4: counts[4]}


def operator_gates(dev) -> None:
    """Phase 19: tpulbm's LES headline (tests/test_les.py: a 256x64
    cylinder at tau 0.503, U 0.1, 4000 steps, where BGK blows up and
    Smagorinsky Cs 0.17 stays finite) and its MRT boundary-feedback gate
    (tests/test_mrt.py: 256x64, tau 0.5768, default rates, 2000 steps,
    finite with max|u| < 0.25; tpulbm runs it in f64, this in f32),
    through the kernels (the N=4 kernel, chunk lengths divide by 4)."""
    from tpulbm_torch import physics
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.stepper import make_chunk_fn

    def run(steps: int, **kw) -> torch.Tensor:
        problem = make_problem(SimulationParams(nx=256, ny=64,
                                                precision="f32", **kw))
        f = initial_state(problem, dev)
        chunk = make_chunk_fn(problem, dev, steps)
        require(chunk.plan == [(4, steps // 4)], f"gate plan {chunk.plan}")
        f = chunk(f)
        torch.cuda.synchronize()
        return problem, f

    les = {}
    for cs in (0.0, 0.17):
        _, f = run(4000, tau=0.503, inlet_velocity=0.1, smagorinsky=cs)
        les[cs] = bool(physics.is_stable(f))
    print(f"operator gates: LES 256x64 tau 0.503 U 0.1, 4000 steps: BGK "
          f"stable {les[0.0]} (gate False), Smagorinsky 0.17 stable "
          f"{les[0.17]} (gate True)")
    require(not les[0.0] and les[0.17], "LES gate failed")
    problem, f = run(2000, tau=0.5768, inlet_velocity=0.05, cylinder_x=0.2,
                     cylinder_y=0.5, cylinder_radius=0.05, collision="mrt")
    stable = bool(physics.is_stable(f))
    _, u = physics.moments(problem.lattice, f)
    max_u = float(torch.sqrt(u[0] ** 2 + u[1] ** 2).max())
    print(f"operator gates: MRT 256x64 tau 0.5768 (default rates, f32), "
          f"2000 steps: stable {stable}, max|u| {max_u:.6f} (gate < 0.25)")
    require(stable and max_u < 0.25, "MRT gate failed")


def operator_phases(dev, card: str) -> list[dict]:
    """Phases 17-20: each 2-D operator's D2Q9 kernels against the plain
    step at 2048x512, its main path through the Runner (and a 64x32 Runner
    through the kernel and the plain step), tpulbm's LES and MRT gates,
    and timing. Returns the kernels' JSON entries."""
    from tpulbm_torch.ops import step_cuda

    t_phases = time.perf_counter()
    entries = []
    for op in OPERATORS:
        params, mode, steps, pstep, f0, errs = operator_parity(dev, op)
        counts = operator_main_path(dev, op, params, mode)
        err_tiny = tiny_runner_agreement(
            dev, f"_{op}", 1e-4 if op == "power_law" else 1e-5,
            **OPERATORS[op])
        print(f"operator runner {op} 64x32, kernel vs plain: forces max abs "
              f"diff {err_tiny:.3e} (rtol 1e-4, atol 5e-6)")
        # phase 20: timing in turns, ms per step (one launch is N steps)
        runs = {"plain": (lambda f, n: plain_chunk(pstep, f, n),
                          PLAIN_2D_STEPS)}
        for n in (1, *DEPTHS):
            runs[n] = (lambda f, m, n=n: kernel_chunk(steps[n], f, m // n),
                       2400)
        order = ["plain", 1, *DEPTHS]
        times = {k: [] for k in order}
        for which in order + order[::-1]:
            run, n = runs[which]
            times[which].append(ms_per_step(run, f0, n, PLAIN_WARM
                                            if which == "plain" else 20))
        ms = {k: min(v) for k, v in times.items()}
        cells = params.nx * params.ny
        kind = f"d2q9_{mode}"
        b = {n: bound(kind, cells, n) for n in (1, *DEPTHS)}
        print(f"operator timing {op} at {params.nx}x{params.ny} on {card}, "
              f"ms/step (MLUPS): plain {ms['plain']:.5f} "
              f"({cells / ms['plain'] / 1e3:.1f}); "
              + "; ".join(
                  f"{'1-step' if n == 1 else f'N={n}'} {ms[n]:.5f} "
                  f"({cells / ms[n] / 1e3:.1f}, runs "
                  f"{[round(v, 6) for v in times[n]]}), "
                  f"{100 * b[n]['bound_ms'] / ms[n]:.1f}% of "
                  f"{b[n]['bound_ms']:.5f} ({b[n]['bound_by']})"
                  for n in (1, *DEPTHS)))
        for n in (1, *DEPTHS):
            entries.append({
                "name": f"d2q9_collide_stream{'' if n == 1 else f'_n{n}'}"
                        f"[{op}]",
                "route": "cuda",
                "source": (step_cuda.KERNEL_SOURCE if n == 1
                           else step_cuda.BLOCKED_SOURCE),
                "replaces": (step_cuda.REPLACES if n == 1
                             else step_cuda.BLOCKED_REPLACES[n]),
                "launches": counts[n], "max_abs_err": errs[n], "ms": ms[n],
                "plain_ms": ms["plain"], **b[n]})
        del steps, pstep, f0
        torch.cuda.empty_cache()
    operator_gates(dev)
    print(f"operator phases 17-20: {time.perf_counter() - t_phases:.2f} s")
    return entries


def sphere_operator_parity(dev, op: str):
    """Phase 21 for one operator: at 256^3, one 1-step kernel step against
    one plain step from the initial state, from the state the operator's
    own 1-step kernel advanced 100 steps and from the perturbed state (the
    power law at tpulbm's rtol 1e-4), with the BGK library's step at least
    SEPARATION tolerances off on the last; the N = 2, 3 kernels bitwise
    against N 1-step launches from all three; 280 kernel steps against 280
    plain steps at
    128^3 (bounded by 1e-4); tpulbm's own 3-D gate of the operator, the
    kernels (the chunk's plan) against the plain step. Returns (the params,
    the collision mode, the kernel steps by depth, the initial state, the
    larger one-step error)."""
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda, step_torch
    from tpulbm_torch.stepper import make_chunk_fn

    def build(n: int, **kw):
        d = dict(problem="cylinder3d", nx=n, ny=n, nz=n, inlet_velocity=0.05,
                 precision="f32", enable_vtk=False)
        d.update(OPERATORS_3D[op], **kw)
        params = SimulationParams(**d)
        return params, make_problem(params)

    tol = PLAW_TOL if op == "power_law" else ONE_STEP_TOL
    params, problem = build(SPHERE_N)
    mode = step_torch.collision_mode(problem)
    steps = {1: step_cuda.make_local_step_cuda_3d(problem, dev)}
    for d in DEPTHS_3D:
        steps[d] = step_cuda.make_local_step_cuda_3d_blocked(problem, dev, d)
    pstep = step_torch.make_step_rolled(problem, dev)
    bgk = step_cuda.make_local_step_cuda_3d(make_problem(params.replace(
        collision="bgk", smagorinsky=0.0, power_law_n=1.0)), dev)
    f0 = initial_state(problem, dev)
    f100 = kernel_chunk(steps[1], f0.clone(), 100)
    fp = perturbed(problem, f0)
    errs = []
    for f in (f0, f100, fp):
        got = steps[1](f, torch.empty_like(f))
        want = pstep(f)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        errs.append(float((got - want).abs().max()))
        if f is fp:
            sep = separation(f"3-D {op}", bgk(f, torch.empty_like(f)), want,
                             tol)
        for d in DEPTHS_3D:
            got = steps[d](f, torch.empty_like(f))
            want = kernel_chunk(steps[1], f.clone(), d)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"3-D {op} N={d}: {float((got - want).abs().max())} off "
                    f"{d} 1-step launches")
    del f100, fp, got, want
    # 280 steps at 128^3
    _, small = build(DRIFT_N_3D)
    s0 = initial_state(small, dev)
    sk = kernel_chunk(step_cuda.make_local_step_cuda_3d(small, dev),
                      s0.clone(), 280)
    sp = plain_chunk(step_torch.make_step_rolled(small, dev), s0, 280)
    torch.cuda.synchronize()
    err_280 = float((sk - sp).abs().max())
    require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
            f"3-D {op}: 280-step drift {err_280} beyond {DRIFT_280_BOUND}")
    del s0, sk, sp
    # tpulbm's gate grid
    grid, n_gate = GATES_3D[op]
    gp = SimulationParams(problem="cylinder3d", inlet_velocity=0.05,
                          precision="f32", **OPERATORS_3D[op], **grid)
    gate = make_problem(gp)
    g0 = initial_state(gate, dev)
    kchunk = make_chunk_fn(gate, dev, n_gate, backend="pallas")
    got = kchunk(g0.clone())
    want = make_chunk_fn(gate, dev, n_gate, backend="jax")(g0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **tol)
    err_gate = float((got - want).abs().max())
    print(f"3-D operator parity {op} ({mode}, {OPERATORS_3D[op]}) at "
          f"{SPHERE_N}^3: 1 step max abs err {errs[0]:.3e} from the initial "
          f"state, {errs[1]:.3e} after 100 kernel steps, {errs[2]:.3e} on "
          f"the perturbed state (rtol {tol['rtol']:.0e}, atol "
          f"{tol['atol']:.0e}), where the BGK library misses the plain step "
          f"by {sep:.0f}x the tolerance (gate > {SEPARATION}x); N=2/3 "
          f"bitwise against N 1-step launches from all three; 280 steps at "
          f"{DRIFT_N_3D}^3 {err_280:.3e} (bound {DRIFT_280_BOUND}); tpulbm's "
          f"gate {gp.nx}x{gp.ny}x{gp.nz} tau {gp.tau}, {n_gate} steps as "
          f"{kchunk.plan}: {err_gate:.3e}")
    return params, mode, steps, f0, max(errs)


def sphere_operator_main_path(dev, op: str, params, mode: str) -> dict:
    """Phase 22 for one operator: the Runner at 256^3 f32, CUT_3D_STEPS
    steps every 140, no VTK, counted: exactly tpulbm's plan's launches
    (LAUNCHES_3D), all of the operator's libraries, and none of another
    kernel; finite force rows and a finite fields3d.npz. Returns the
    launches by depth."""
    from tpulbm_torch.ops import step_cuda

    n = SPHERE_N
    run_dir = OUT_DIR / f"sphere{n}_{op}"
    steps, want = CUT_3D_STEPS, LAUNCHES_3D[CUT_3D_STEPS]
    result, counts, wall = run_counted(
        params.replace(num_timesteps=steps, output_frequency=140,
                       output_dir=str(run_dir)), dev)
    one = step_cuda.launches_by_mode(step_cuda.collide_stream_3d)
    blocked = step_cuda.launches_by_mode(step_cuda.collide_stream_3d_blocked)
    by_mode = (one[mode], *(blocked[mode][d] for d in DEPTHS_3D))
    require(counts == {**only("3d3", want[3]), "3d2": want[2], "3d": want[1]}
            and by_mode == (want[1], want[2], want[3]),
            f"3-D {op}: launch counts {counts} ({by_mode} of {mode}), not "
            f"{want} by depth and 0 others")
    forces = check_forces(run_dir, list(range(0, steps, 140)))
    with np.load(run_dir / "fields3d.npz") as fields:
        for name in ("rho", "ux", "uy", "uz"):
            require(fields[name].shape == (n, n, n)
                    and bool(np.isfinite(fields[name]).all()),
                    f"3-D {op}: fields3d.npz {name} not a finite {n}^3 field")
    print(f"3-D operator main path {op}: sphere {n}^3 f32, {steps} steps, "
          f"launches {counts['3d3']} N=3 + {counts['3d2']} N=2 + "
          f"{counts['3d']} one-step of {mode}, {result.host_fetches} host "
          f"fetches in the loop, {wall:.2f} s wall, runner "
          f"{result.mlups:.1f} MLUPS, final C_D {forces[-1, 3]:.6f}")
    return {1: counts["3d"], 2: counts["3d2"], 3: counts["3d3"]}


def sphere_operator_phases(dev, card: str) -> list[dict]:
    """Phases 21-23: each 3-D operator's D3Q19 kernels against the plain
    step and each other at 256^3 (and tpulbm's gate grids), its main path
    through the Runner, and timing. Returns the kernels' JSON entries."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda, step_torch

    t_phases = time.perf_counter()
    entries = []
    for op in OPERATORS_3D:
        params, mode, steps, f0, err = sphere_operator_parity(dev, op)
        counts = sphere_operator_main_path(dev, op, params, mode)
        # phase 23: timing in turns at 256^3, ms per step (one launch is N
        # steps); the plain step (host-bound, 100-400 ms a step) 4 steps a
        # turn after 2
        pstep = step_torch.make_step_rolled(make_problem(params), dev)
        runs = {"plain": (lambda f, m: plain_chunk(pstep, f, m),
                          PLAIN_3D_STEPS, PLAIN_WARM)}
        for n in (1, *DEPTHS_3D):
            runs[n] = (lambda f, m, n=n: kernel_chunk(steps[n], f, m // n),
                       150, 20)
        order = ["plain", 1, *DEPTHS_3D]
        times = {k: [] for k in order}
        for which in order + order[::-1]:
            run, m, warm = runs[which]
            times[which].append(ms_per_step(run, f0, m, warm))
        ms = {k: min(v) for k, v in times.items()}
        cells = SPHERE_N ** 3
        kind = f"d3q19_{mode}"
        b = {n: bound(kind, cells, n) for n in (1, *DEPTHS_3D)}
        print(f"3-D operator timing {op} at {SPHERE_N}^3 on {card}, ms/step "
              f"(MLUPS): "
              + "; ".join(
                  f"{'1-step' if n == 1 else f'N={n}'} {ms[n]:.5f} "
                  f"({cells / ms[n] / 1e3:.1f}, runs "
                  f"{[round(v, 6) for v in times[n]]}), "
                  f"{100 * b[n]['bound_ms'] / ms[n]:.1f}% of "
                  f"{b[n]['bound_ms']:.5f} ({b[n]['bound_by']})"
                  for n in (1, *DEPTHS_3D))
              + f"; plain {ms['plain']:.5f} (runs "
              f"{[round(v, 6) for v in times['plain']]})")
        for n in (1, *DEPTHS_3D):
            entries.append({
                "name": f"d3q19_collide_stream{'' if n == 1 else f'_n{n}'}"
                        f"[{op}]",
                "route": "cuda",
                "source": (step_cuda.SOURCE_3D if n == 1
                           else step_cuda.SOURCE_3D_BLOCKED),
                "replaces": (step_cuda.REPLACES_3D if n == 1
                             else step_cuda.REPLACES_3D_BLOCKED),
                "launches": counts[n], "max_abs_err": err, "ms": ms[n],
                "plain_ms": ms["plain"], **b[n]})
        del steps, f0, pstep
        torch.cuda.empty_cache()
    print(f"3-D operator phases 21-23: {time.perf_counter() - t_phases:.2f} s")
    return entries


def thermal_les_phases(dev, card: str) -> dict:
    """Phase 24: the thermal kernel's LES build (Cs 0.17) at the 2048x512
    Rayleigh-Bénard row against the plain LES step (one step from both
    states and from the perturbed state, where the BGK build's step must
    lie SEPARATION tolerances off; 280 steps), tpulbm's LES gate of the
    thermal kernel, the
    Runner (exactly 2240 launches of the LES build), and timing. Returns
    the kernel's JSON entry."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda, step_thermal_cuda
    from tpulbm_torch.stepper import make_chunk_fn

    t_phase = time.perf_counter()
    nx, ny = THERMAL_NX, THERMAL_NY
    err, kstep, pstep, s0 = thermal_parity(dev, "rayleigh-benard", nx, ny,
                                           smagorinsky=THERMAL_CS)
    # the perturbed state: the LES build against the plain LES step, and
    # the BGK build's step off it
    les = make_problem(thermal_params("rayleigh-benard", nx, ny,
                                      smagorinsky=THERMAL_CS))
    bgk = step_thermal_cuda.make_local_step_thermal_cuda(
        make_problem(thermal_params("rayleigh-benard", nx, ny)), dev)
    sp = perturbed(les, s0)
    got = kstep(sp, torch.empty_like(sp))
    want = pstep(sp)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONE_STEP_TOL)
    err_p = float((got - want).abs().max())
    sep = separation("thermal LES", bgk(sp, torch.empty_like(sp)), want,
                     ONE_STEP_TOL)
    err = max(err, err_p)
    print(f"thermal LES parity {nx}x{ny} on the perturbed state: 1 step max "
          f"abs err {err_p:.3e} (rtol 5e-6, atol 1e-7); the BGK build misses "
          f"the plain LES step by {sep:.0f}x the tolerance (gate > "
          f"{SEPARATION}x)")
    del sp, got, want
    # tpulbm's gate: 32x32, Ra 5000, 12 steps, the kernel against the plain
    # step
    gate = make_problem(thermal_params("rayleigh-benard", 32, 32,
                                       smagorinsky=THERMAL_CS).replace(
                                           rayleigh=5000.0))
    g0 = initial_state(gate, dev)
    got = make_chunk_fn(gate, dev, 12, backend="pallas")(g0.clone())
    want = make_chunk_fn(gate, dev, 12, backend="jax")(g0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **THERMAL_LES_TOL)
    print(f"thermal LES gate 32x32 Ra 5000, 12 steps: kernel vs plain max "
          f"abs err {float((got - want).abs().max()):.3e} (rtol 2e-5, atol "
          f"1e-6)")
    run_dir = OUT_DIR / "rayleigh_benard_2048x512_les"
    params = thermal_params("rayleigh-benard", nx, ny, smagorinsky=THERMAL_CS,
                            num_timesteps=2240, output_frequency=140,
                            output_dir=str(run_dir))
    result, counts, wall = run_counted(params, dev)
    by_mode = step_cuda.launches_by_mode(
        step_thermal_cuda.collide_stream_thermal)
    require(counts == only("thermal", 2240)
            and by_mode == {"bgk": 0, "smagorinsky": 2240},
            f"thermal LES: launch counts {counts} ({by_mode}), not 2240 of "
            "the LES build and 0 others")
    final_nusselt(run_dir, list(range(0, 2240, 140)))
    print(f"thermal LES main path: rayleigh-benard {nx}x{ny} f32 Ra 1e4 Cs "
          f"{THERMAL_CS}, 2240 steps, launches {by_mode['smagorinsky']} of "
          f"the LES build, {result.host_fetches} host fetches in the loop, "
          f"{wall:.2f} s wall, runner {result.mlups:.1f} MLUPS, final Nu "
          f"{result.stats['nusselt']:.6f}")
    runs = {"plain": (lambda f, n: plain_chunk(pstep, f, n),
                      PLAIN_2D_STEPS),
            "kernel": (lambda f, n: kernel_chunk(kstep, f, n), 2400)}
    times = {k: [] for k in runs}
    for which in ["plain", "kernel", "kernel", "plain"]:
        run, steps = runs[which]
        times[which].append(ms_per_step(run, s0, steps, PLAIN_WARM
                                        if which == "plain" else 20))
    ms = {k: min(v) for k, v in times.items()}
    cells = nx * ny
    b = bound("thermal_smagorinsky", cells)
    print(f"thermal LES timing at {nx}x{ny} on {card}, ms/step (MLUPS): "
          f"plain {ms['plain']:.5f} ({cells / ms['plain'] / 1e3:.1f}, runs "
          f"{[round(v, 6) for v in times['plain']]}); kernel "
          f"{ms['kernel']:.5f} ({cells / ms['kernel'] / 1e3:.1f}, runs "
          f"{[round(v, 6) for v in times['kernel']]}), "
          f"{100 * b['bound_ms'] / ms['kernel']:.1f}% of its bound "
          f"{b['bound_ms']:.5f} ms ({b['bound_by']})")
    print(f"thermal LES phase 24: {time.perf_counter() - t_phase:.2f} s")
    return {"name": "thermal_collide_stream[smagorinsky]", "route": "cuda",
            "source": step_thermal_cuda.SOURCE,
            "replaces": step_thermal_cuda.REPLACES,
            "launches": by_mode["smagorinsky"], "max_abs_err": err,
            "ms": ms["kernel"], "plain_ms": ms["plain"], **b}


# ---- phases 25-29: the channel, the cavity, the bounce-back obstacle and
# ---- the duct (the kernels' domains, source and obstacle rule)

# the channel's force: u_max = F (ny-1)^2 / (8 nu) = 0.04994 at 2048x512,
# tau 0.8 (nu 0.1)
CHANNEL_FORCE = 1.53e-7
# the duct's peak speed (analytic_profile_duct) sets its force
DUCT_U_MAX = 0.05
# the cavity: Re 1000 at U 0.1 on 1024^2, tau = 3 U (n-1) / Re + 1/2
CAVITY_N, CAVITY_RE, CAVITY_U = 1024, 1000.0, 0.1
# tests/test_cavity.py's pallas-vs-jax gate (its corner residual cancels
# terms of ~0.5 down to ~1e-5)
CAVITY_TOL = dict(rtol=2e-5, atol=5e-7)
CAVITY_MASS_TOL = 1e-6
# the 2-D collisions with the ladder's flags where they need them, and the
# 3-D ones (OPERATORS, OPERATORS_3D), by their collision mode
CHANNEL_OPS = {"bgk": {}, "mrt": dict(collision="mrt"),
               "power_law": dict(power_law_n=0.7),
               "trt": dict(collision="trt"),
               "regularized": dict(collision="regularized"),
               "kbc": dict(collision="kbc"),
               "smagorinsky": dict(smagorinsky=0.17)}
# the channel's collisions held in full (every state, N = 2, 3, 4, 280
# steps); the rest from the perturbed state at N = 4
CHANNEL_FULL = ("bgk", "mrt", "power_law")
DUCT_OPS = {op: kw for op, kw in CHANNEL_OPS.items() if op != "kbc"}
# the cylinder and the sphere under a body force: the channel's force
OBSTACLE_FORCE = CHANNEL_FORCE
# At the cells' forces the source 3 w_i c_i.F is below the one-step
# tolerance, so a library that dropped it would pass there. The source's
# own check steps each forced cell at this force along x, where an axis
# population's source (F/3 in 2-D, F/6 in 3-D) is over 250 power-law
# tolerances and over 4000 of the others; a library built without the
# source must miss the plain step there by SEPARATION tolerances.
SOURCE_CHECK_FORCE = 1e-2


def new_builds():
    """(source, mode, variant) of every library the phases 25-29 build:
    each D2Q9 collision in the channel with the source (and its 1-step
    library without, for the source's check), the cavity, the bounce-back
    cylinder and the cylinder with the source under BGK; each D3Q19
    collision in the duct likewise, the bounce-back sphere and the sphere
    with the source under BGK."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.ops.step_cuda import BOUNCE_BACK, SOURCE
    channel = step_cuda.DOMAINS.index("channel")
    cavity = step_cuda.DOMAINS.index("cavity")
    duct = step_cuda.DOMAINS_3D.index("duct")
    d2 = ("step_d2q9.cu", "step_d2q9_blocked.cu")
    d3 = ("step_d3q19.cu", "step_d3q19_blocked.cu")
    builds = [(src, mode, channel | SOURCE)
              for mode in step_cuda.COLLISION_MODES for src in d2]
    builds += [(d2[0], mode, channel) for mode in step_cuda.COLLISION_MODES]
    builds += [(src, "bgk", v) for v in (cavity, BOUNCE_BACK, SOURCE)
               for src in d2]
    builds += [(src, mode, duct | SOURCE)
               for mode in step_cuda.COLLISION_MODES_3D for src in d3]
    builds += [(d3[0], mode, duct) for mode in step_cuda.COLLISION_MODES_3D]
    builds += [(src, "bgk", v) for v in (BOUNCE_BACK, SOURCE) for src in d3]
    return builds


def channel_params(nx=2048, ny=512, **kw):
    from tpulbm_torch.config import SimulationParams
    d = dict(problem="poiseuille", nx=nx, ny=ny, tau=0.8, inlet_velocity=0.0,
             body_force=(CHANNEL_FORCE, 0.0), precision="f32",
             enable_vtk=False)
    d.update(kw)
    return SimulationParams(**d)


def cavity_params(n=CAVITY_N, re=CAVITY_RE, u=CAVITY_U, **kw):
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.models.cavity import tau_for_cavity_reynolds
    return SimulationParams(problem="cavity", nx=n, ny=n, inlet_velocity=u,
                            tau=tau_for_cavity_reynolds(re, u, n),
                            cylinder_radius=0.0, precision="f32",
                            enable_vtk=False, **kw)


def duct_params(n=SPHERE_N, **kw):
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.models.poiseuille import analytic_profile_duct
    d = dict(problem="poiseuille", nx=n, ny=n, nz=n, tau=0.8,
             inlet_velocity=0.0, precision="f32", enable_vtk=False)
    d.update(kw)
    unit = analytic_profile_duct(SimulationParams(
        **{**d, "body_force": (1.0, 0.0, 0.0)}))
    d.setdefault("body_force", (DUCT_U_MAX / float(unit.max()), 0.0, 0.0))
    return SimulationParams(**d)


def duct_at(params, n: int):
    """The duct of `params`' collision at n^3 (its force for u_max 0.05)."""
    return duct_params(n, **{k: getattr(params, k) for k in (
        "collision", "power_law_n", "smagorinsky", "lattice3d")})


def obstacle_params(three_d: bool, **kw):
    """re200 or the 256^3 sphere (bench.py's d3q19 row), f32, no VTK, with
    SimulationParams `kw` (obstacle_bc, body_force)."""
    from tpulbm_torch.config import PRESETS, SimulationParams
    if three_d:
        return SimulationParams(problem="cylinder3d", nx=SPHERE_N,
                                ny=SPHERE_N, nz=SPHERE_N, inlet_velocity=0.05,
                                precision="f32", enable_vtk=False, **kw)
    return PRESETS["re200"].replace(precision="f32", enable_vtk=False, **kw)


class Cell:
    """One new domain's problem on the card: its kernel steps by depth, the
    plain step, the constants and the separation library's step."""

    def __init__(self, dev, label: str, params, problem=None, remake=None):
        from tpulbm_torch.models import make_problem
        from tpulbm_torch.ops import step_cuda, step_torch

        self.label, self.params = label, params
        # `problem`: one that params alone do not give (a force along x,
        # the slab); remake(**kw): the cell's problem with SimulationParams
        # fields `kw` changed (default: make_problem of params with them)
        self.problem = make_problem(params) if problem is None else problem
        self.remake = remake or (lambda **kw: make_problem(
            params.replace(**kw)))
        self.three_d = self.problem.lattice.D == 3
        self.consts = step_cuda.StepConstants.of(self.problem)
        self.library = self.consts.library
        if self.three_d:
            self.depths = (1, *DEPTHS_3D)
            make1 = step_cuda.make_local_step_cuda_3d
            makeN = step_cuda.make_local_step_cuda_3d_blocked
            launch = step_cuda.collide_stream_3d
        else:
            self.depths = (1, *DEPTHS)
            make1 = step_cuda.make_local_step_cuda
            makeN = step_cuda.make_local_step_cuda_blocked
            launch = step_cuda.collide_stream
        self.make1, self.launch = make1, launch
        self.steps = {1: make1(self.problem, dev)}
        for d in self.depths[1:]:
            self.steps[d] = makeN(self.problem, dev, d)
        self.pstep = step_torch.make_step_rolled(self.problem, dev)
        # the obstacle domain's library of the same collision, with the
        # equilibrium obstacle and no source: the build every earlier slice
        # ran, which the new edge code must be seen to change
        base = dataclasses.replace(
            self.consts, variant=self.consts.variant & step_cuda.D3Q27,
            src=(), lid=(0.0, 0.0), force_table=(), force_axis=-1)
        self.solid = (torch.zeros(self.problem.spatial_shape,
                                  dtype=torch.uint8, device=dev)
                      if self.problem.solid is None else
                      torch.as_tensor(self.problem.solid, device=dev)
                      .to(torch.uint8))
        self.base = lambda f, out: launch(f, out, self.solid, base)
        mode = self.consts.mode
        self.tol = (CAVITY_TOL if params.problem == "cavity" else
                    PLAW_TOL if mode == "power_law" else ONE_STEP_TOL)
        self.relative = mode == "kbc"
        self.f0 = initial_state(self.problem, dev)

    def bound(self, steps_per_launch: int) -> dict:
        """bound() of one step of the cell's library: the populations read
        and written once, the mask where the obstacle domain's kernel reads
        it; the collision's operations (BGK's where bounce-back solids skip
        it, an upper bound) and one add a population for the source and
        one for the force profile."""
        from tpulbm_torch.ops import step_cuda
        lat = (("d3q27" if self.problem.lattice.Q == 27 else "d3q19")
               if self.three_d else "d2q9")
        mode = self.consts.mode
        q, v = self.problem.lattice.Q, self.consts.variant
        mask = not v & step_cuda.DOMAIN_BITS
        flops = STEP_FLOPS[lat if mode == "bgk" else f"{lat}_{mode}"]
        return bound_of(q * 4 * 2 + int(mask),
                        flops + (q if v & step_cuda.SOURCE else 0)
                        + (q if v & step_cuda.FORCE else 0),
                        int(np.prod(self.problem.spatial_shape)),
                        steps_per_launch)


def source_check(cell: Cell, f: torch.Tensor) -> tuple[float, float]:
    """The body force's source on the card: at SOURCE_CHECK_FORCE along x,
    one step of the cell's 1-step library from f against the plain step
    (at the cell's tolerance), and one of the same domain's library built
    without the source, which must miss the plain step by more than
    SEPARATION tolerances. Returns (the library's error, the separation)."""
    from tpulbm_torch.ops import bouzidi, step_cuda, step_torch
    force = (SOURCE_CHECK_FORCE,) + (0.0,) * (cell.problem.lattice.D - 1)
    big = cell.remake(body_force=force)
    consts = step_cuda.StepConstants.of(big)
    require(consts.library == cell.library, f"{cell.label}: the check's "
            f"library {consts.library}, not {cell.library}")
    bare = dataclasses.replace(consts, src=(),
                               variant=consts.variant & ~step_cuda.SOURCE)
    got = cell.make1(big, f.device)(f, torch.empty_like(f))
    want = step_torch.make_step_rolled(big, f.device)(f)
    mask, links = cell.solid, None
    if bare.variant & step_cuda.BOUZIDI:
        # the Bouzidi build reads the link bits and the table
        mask = torch.as_tensor(step_cuda.kernel_mask(big), device=f.device)
        links = bouzidi.device_table(big, f.device)
    without = cell.launch(f, torch.empty_like(f), mask, bare, None, links)
    torch.cuda.synchronize()
    close_or_relative(got, want, cell.tol, cell.relative)
    sep = separation(f"{cell.label}, {bare.library} at F {SOURCE_CHECK_FORCE}",
                     without, want, cell.tol)
    return float((got - want).abs().max()), sep


def force_check(cell: Cell, f: torch.Tensor, axis: str) -> tuple[float,
                                                                  float]:
    """The force profile on the card: the cell's problem with Kolmogorov's
    profile at F0 = SOURCE_CHECK_FORCE along `axis` (y: F_x = F0 cos(κy),
    x: F_y = F0 cos(κx), tpulbm's tests/test_kolmogorov.py:239; z, 3-D:
    F_x = F0 cos(κz)), one step
    of the cell's 1-step library from f against the plain step, and one of
    the same domain's library built without the profile, which must miss
    the plain step by more than SEPARATION tolerances. Returns (the
    library's error, the separation)."""
    from tpulbm_torch.models.base import ForceProfile
    from tpulbm_torch.ops import step_cuda, step_torch
    n = cell.problem.spatial_shape[::-1]["xyz".index(axis)]
    k = 2.0 * np.pi * cell.params.kolmogorov_n / n
    f0 = SOURCE_CHECK_FORCE
    fn = ((lambda c: (f0 * torch.cos(k * c), 0.0)) if axis == "y"
          else (lambda c: (0.0, f0 * torch.cos(k * c)))
          if axis == "x" else (lambda c: (f0 * torch.cos(k * c), 0.0, 0.0)))
    big = dataclasses.replace(cell.problem,
                              force_profile=ForceProfile(axis, fn))
    consts = step_cuda.StepConstants.of(big)
    require(consts.library == cell.library, f"{cell.label}: the check's "
            f"library {consts.library}, not {cell.library}")
    bare = dataclasses.replace(consts, force_table=(), force_axis=-1,
                               variant=consts.variant & ~step_cuda.FORCE)
    got = cell.launch(f, torch.empty_like(f), cell.solid, consts)
    want = step_torch.make_step_rolled(big, f.device)(f)
    without = cell.launch(f, torch.empty_like(f), cell.solid, bare)
    torch.cuda.synchronize()
    close_or_relative(got, want, cell.tol, cell.relative)
    sep = separation(f"{cell.label}, {bare.library} with the profile along "
                     f"{axis} at F0 {f0}", without, want, cell.tol)
    return float((got - want).abs().max()), sep


def cell_parity(cell: Cell, full: bool, advanced: bool = True,
                check_source: bool = True, drift_n: int = DRIFT_N_3D,
                drift: bool = True) -> float:
    """Phase 25 (2-D) or 27 (3-D) on one cell: one 1-step kernel step
    against one plain step from the perturbed state (and, `full`, from the
    initial state and an advanced one: 500 plain steps in 2-D, 100 kernel
    steps in 3-D), where the obstacle domain's library of the same
    collision must miss the plain step by more than SEPARATION tolerances
    if the cell's domain or obstacle rule differs from it, and the source
    must show (source_check) if the cell's library has one;
    the N-step kernels bitwise against N 1-step launches from each state;
    with `full`, 280 kernel steps against 280 plain steps (3-D at
    drift_n^3); without `advanced`, no advanced state; without
    `check_source`, no source check; without `drift`, no 280 steps.
    Returns the larger one-step error."""
    from tpulbm_torch.ops.step_cuda import D3Q27, FORCE, SOURCE
    s1 = cell.steps[1]
    fp = perturbed(cell.problem, cell.f0)
    states = [("perturbed", fp)]
    if full and advanced:
        adv = (kernel_chunk(s1, cell.f0.clone(), 100) if cell.three_d
               else plain_chunk(cell.pstep, cell.f0.clone(), 500))
        states = [("initial", cell.f0), ("advanced", adv)] + states
    elif full:
        states = [("initial", cell.f0)] + states
    names = [name for name, _ in states]
    errs, held, seps = [], [], []
    for name, f in states:
        got = s1(f, torch.empty_like(f))
        want = cell.pstep(f)
        torch.cuda.synchronize()
        held.append(close_or_relative(got, want, cell.tol, cell.relative))
        errs.append(float((got - want).abs().max()))
        if name == "perturbed" and cell.consts.variant & D3Q27:
            sep = d3q19_separation(cell, f, want)
            seps.append(f"the D3Q19 {cell.consts.mode} library on its 19 "
                        f"planes misses the plain D3Q27 step's by {sep:.0f}x "
                        "the tolerance")
        if name == "perturbed" and cell.consts.variant & ~(SOURCE | FORCE
                                                           | D3Q27):
            # a domain or obstacle rule beyond the cylinder's
            sep = separation(cell.label, cell.base(f, torch.empty_like(f)),
                             want, cell.tol)
            seps.append(f"the obstacle domain's {cell.consts.mode} library "
                        f"misses the plain step on the perturbed state by "
                        f"{sep:.0f}x the tolerance")
        if (name == "perturbed" and cell.consts.variant & SOURCE
                and check_source):
            err_src, sep = source_check(cell, f)
            errs.append(err_src)
            seps.append(f"at F = {SOURCE_CHECK_FORCE} from the perturbed "
                        f"state 1 step max abs err {err_src:.3e} and the "
                        f"library without the source {sep:.0f}x the "
                        f"tolerance off")
        if name == "perturbed" and cell.consts.variant & FORCE:
            for axis in (("z",) if cell.three_d else ("y", "x")):
                err_f, sep = force_check(cell, f, axis)
                errs.append(err_f)
                seps.append(f"the force profile along {axis} at F0 = "
                            f"{SOURCE_CHECK_FORCE} from the perturbed state "
                            f"1 step max abs err {err_f:.3e} and the box's "
                            f"library without it {sep:.0f}x the tolerance "
                            "off")
        for d in (cell.depths[1:] if full else cell.depths[-1:]):
            gotn = cell.steps[d](f, torch.empty_like(f))
            wantn = kernel_chunk(s1, f.clone(), d)
            torch.cuda.synchronize()
            require(torch.equal(gotn, wantn),
                    f"{cell.label} N={d} from the {name} state: "
                    f"{float((gotn - wantn).abs().max())} off {d} 1-step "
                    "launches")
    del states, got, want, gotn, wantn, fp
    torch.cuda.empty_cache()
    drift_text = ""
    if full and drift:
        if cell.three_d:
            from tpulbm_torch.models import make_problem
            from tpulbm_torch.ops import step_cuda, step_torch
            n = min(drift_n, cell.params.nx)
            small = make_problem(
                duct_at(cell.params, n) if cell.params.problem == "poiseuille"
                else cell.params.replace(nx=n, ny=n, nz=n))
            s0 = initial_state(small, cell.f0.device)
            sk = kernel_chunk(step_cuda.make_local_step_cuda_3d(
                small, cell.f0.device), s0.clone(), 280)
            sp = plain_chunk(step_torch.make_step_rolled(
                small, cell.f0.device), s0, 280)
        else:
            sk = kernel_chunk(s1, cell.f0.clone(), 280)
            sp = plain_chunk(cell.pstep, cell.f0.clone(), 280)
        torch.cuda.synchronize()
        err_280 = float((sk - sp).abs().max())
        require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
                f"{cell.label}: 280-step drift {err_280} beyond "
                f"{DRIFT_280_BOUND}")
        drift_text = (f"; 280 steps{f' at {n}^3' if cell.three_d else ''}"
                      f" {err_280:.3e} (bound {DRIFT_280_BOUND})")
        del sk, sp
    shape = "x".join(str(v) for v in cell.problem.spatial_shape[::-1])
    print(f"domain parity {cell.label} [{cell.library}] {shape}: 1 step max "
          f"abs err "
          + ", ".join(f"{e:.3e} ({n})" for e, n in zip(errs, names))
          + f" ({held[-1]} held); " + "; ".join(seps)
          + f" (gate > {SEPARATION}x); N="
          + "/".join(str(d) for d in (cell.depths[1:] if full
                                      else cell.depths[-1:]))
          + " bitwise against N 1-step launches" + drift_text)
    torch.cuda.empty_cache()
    return max(errs)


def cell_main_path(dev, cell: Cell, run_dir: Path, mass: bool = False,
                   steps: int = 2240) -> dict:
    """Phase 26 (2-D) or 28 (3-D) on one cell: the Runner for `steps`
    steps (2240, or CUT_3D_STEPS where a phase's depth was cut) every 140,
    no VTK, counted: exactly the one-device plan's launches (2-D
    LAUNCHES_2D, 3-D LAUNCHES_3D), every one from the cell's own library,
    and none of another kernel; a finite field; with `mass` (the closed
    cavity) a final checkpoint whose total mass lies within
    CAVITY_MASS_TOL of the start. Returns the launches by depth."""
    from tpulbm_torch.ops import step_cuda
    params = cell.params.replace(
        num_timesteps=steps, output_frequency=140, output_dir=str(run_dir),
        checkpoint_every=17 if mass else 0)
    result, counts, wall = run_counted(params, dev)
    lib = cell.library
    if cell.three_d:
        n3 = LAUNCHES_3D[steps]
        want = {**only("3d3", n3[3]), "3d2": n3[2], "3d": n3[1]}
        by_lib = (step_cuda.collide_stream_3d.launches_by_library,
                  step_cuda.collide_stream_3d_blocked.launches_by_library)
        ok = by_lib == ({lib: n3[1]}, {lib: {2: n3[2], 3: n3[3]}})
        launches = {1: counts["3d"], 2: counts["3d2"], 3: counts["3d3"]}
    else:
        n4 = LAUNCHES_2D[steps]
        want = {**only(4, n4), 1: 140}
        by_lib = (step_cuda.collide_stream.launches_by_library,
                  step_cuda.collide_stream_blocked.launches_by_library)
        ok = by_lib == ({lib: 140}, {lib: {2: 0, 3: 0, 4: n4}})
        launches = {1: counts[1], 4: counts[4]}
    require(counts == want and ok,
            f"{cell.label}: launch counts {counts} {by_lib}, not {want} all "
            f"of {lib}")
    if params.is_3d:
        with np.load(run_dir / "fields3d.npz") as fields:
            require(all(bool(np.isfinite(fields[k]).all())
                        for k in ("rho", "ux", "uy", "uz")),
                    f"{cell.label}: fields3d.npz not finite")
    else:
        text = (run_dir / "velocity_field.csv").read_bytes().lower()
        require(text.count(b"\n") == params.nx * params.ny + 1
                and b"nan" not in text and b"inf" not in text,
                f"{cell.label}: velocity_field.csv not a finite field")
    extra = ""
    if cell.problem.solid is not None:
        forces = check_forces(run_dir, list(range(0, steps, 140)))
        extra = f", final C_D {forces[-1, 3]:.6f}"
    else:
        require(not (run_dir / "forces.csv").exists(),
                f"{cell.label}: forces.csv without an obstacle")
    if mass:
        ckpts = sorted(os.listdir(run_dir / "checkpoints"))
        require(ckpts[-1] == "ckpt_000002240.npz", f"checkpoints {ckpts}")
        with np.load(run_dir / "checkpoints" / ckpts[-1]) as z:
            m = float(np.sum(z["f"], dtype=np.float64))
        m0 = float(params.nx * params.ny)
        require(abs(m / m0 - 1.0) < CAVITY_MASS_TOL,
                f"cavity mass {m} against {m0}")
        extra += (f", total mass {m:.3f} against {m0:.0f} at the start "
                  f"(relative {m / m0 - 1.0:.3e}, gate {CAVITY_MASS_TOL})")
    shape = (params.nx, params.ny) + ((params.nz,) if params.is_3d else ())
    print(f"domain main path {cell.label}: {params.problem} "
          + "x".join(str(v) for v in shape)
          + f" f32, {steps} steps, launches "
          + " + ".join(f"{n} {'1-step' if d == 1 else f'N={d}'}"
                       for d, n in sorted(launches.items(), reverse=True))
          + f" of {lib} and 0 others, {result.host_fetches} host fetches in "
          f"the loop, {wall:.2f} s wall, runner {result.mlups:.1f} MLUPS"
          + extra)
    return launches


def cell_timing(cell: Cell, card: str, depths=None,
                others: dict | None = None) -> dict:
    """Phase 29 on one cell: the plain step, the 1-step kernel and the
    N-step kernels in turns, ms per step (an N-step launch counts N), the
    lower of two turns; MLUPS and the share of each kernel's bound.
    `others` {label: (step, n_sub)}: more kernels timed in the same turns
    on the cell's state (another library, for a comparison), their ms
    under their labels."""
    depths = depths or cell.depths
    big = cell.three_d
    runs = {"plain": (lambda f, m: plain_chunk(cell.pstep, f, m),
                      PLAIN_3D_STEPS if big else PLAIN_2D_STEPS, PLAIN_WARM)}
    for d in depths:
        runs[d] = (lambda f, m, d=d: kernel_chunk(cell.steps[d], f, m // d),
                   KERNEL_3D_STEPS if big else 2400, 10 if big else 20)
    for label, (step, d) in (others or {}).items():
        runs[label] = (lambda f, m, step=step, d=d: kernel_chunk(
            step, f, m // d), KERNEL_3D_STEPS if big else 2400,
            10 if big else 20)
    order = ["plain", *depths, *(others or {})]
    times = {k: [] for k in order}
    for which in order + order[::-1]:
        run, m, warm = runs[which]
        times[which].append(ms_per_step(run, cell.f0, m, warm))
    ms = {k: min(v) for k, v in times.items()}
    cells = int(np.prod(cell.problem.spatial_shape))
    b = {d: cell.bound(d) for d in depths}
    print(f"domain timing {cell.label} [{cell.library}] on {card}, ms/step "
          f"(MLUPS): plain {ms['plain']:.5f} "
          f"({cells / ms['plain'] / 1e3:.1f}); "
          + "; ".join(f"{'1-step' if d == 1 else f'N={d}'} {ms[d]:.5f} "
                      f"({cells / ms[d] / 1e3:.1f}, runs "
                      f"{[round(v, 6) for v in times[d]]}), "
                      f"{100 * b[d]['bound_ms'] / ms[d]:.1f}% of "
                      f"{b[d]['bound_ms']:.5f} ({b[d]['bound_by']})"
                      for d in depths))
    return ms, b


def cell_entries(cell: Cell, launches: dict, err: float, ms: dict,
                 b: dict) -> list[dict]:
    from tpulbm_torch.ops import step_cuda
    out = []
    for d in sorted(launches):
        if cell.three_d:
            source = step_cuda.SOURCE_3D if d == 1 else \
                step_cuda.SOURCE_3D_BLOCKED
            replaces = step_cuda.REPLACES_3D if d == 1 else \
                step_cuda.REPLACES_3D_BLOCKED
            base = "d3q19_collide_stream"
        else:
            source = step_cuda.KERNEL_SOURCE if d == 1 else \
                step_cuda.BLOCKED_SOURCE
            replaces = step_cuda.REPLACES if d == 1 else \
                step_cuda.BLOCKED_REPLACES[d]
            base = "d2q9_collide_stream"
        out.append({"name": f"{base}{'' if d == 1 else f'_n{d}'}"
                            f"[{cell.library}]",
                    "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[d], "max_abs_err": err, "ms": ms[d],
                    "plain_ms": ms["plain"], **b[d]})
    return out


def domain_gates(dev) -> None:
    """tpulbm's physics gates through the kernels in f32: the Poiseuille
    parabola (tests/test_poiseuille.py: 32x32, tau 0.8, F 2e-6, 12000
    steps, RMSE < 0.005 and < 2% of u_max), the power-law channel
    (tests/test_power_law.py:144-160: 16x24, n 0.5 and 1.5, RMSE < 4% of
    u_max), Ghia at Re 100 (tests/test_cavity.py:196-225: 64^2, 30000
    steps, the centreline extrema and the primary vortex) and the duct's
    Fourier series (tests/test_duct3d.py:33-51: 8x17x17, 6000 steps, RMSE
    < 2% of u_max)."""
    from tpulbm_torch import physics
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.models import poiseuille
    from tpulbm_torch.stepper import make_chunk_fn

    def run(params, steps):
        problem = make_problem(params)
        f = initial_state(problem, dev)
        f = make_chunk_fn(problem, dev, steps)(f)
        torch.cuda.synchronize()
        require(bool(physics.is_stable(f)), f"gate {params.problem} unstable")
        _, u = physics.moments(problem.lattice, f)
        return problem, u.double().cpu().numpy()

    t0 = time.perf_counter()
    params = channel_params(nx=32, ny=32, body_force=(2e-6, 0.0))
    _, u = run(params, 12000)
    prof, ana = u[0][:, 0], poiseuille.analytic_profile(params)
    rmse = float(np.sqrt(np.mean((prof - ana) ** 2)))
    xinv = float(np.abs(u[0] - u[0][:, :1]).max())
    require(rmse < 0.005 and rmse / ana.max() < 0.02 and xinv < 1e-6,
            f"Poiseuille gate: RMSE {rmse}, u_max {ana.max()}, x-variation "
            f"{xinv}")
    print(f"domain gate Poiseuille 32x32 f32, 12000 steps: RMSE {rmse:.3e} "
          f"(gate 0.005), {100 * rmse / ana.max():.3f}% of u_max "
          f"{ana.max():.5f} (gate 2%), x-variation {xinv:.1e}")
    for n, k, force, steps in ((0.5, 4.04e-3, 2.84e-5, 12000),
                               (1.5, 1.67, 3.16e-5, 16000)):
        params = channel_params(nx=16, ny=24, body_force=(force, 0.0),
                                power_law_n=n, power_law_k=k)
        _, u = run(params, steps)
        prof = u[0][:, 0]
        ana = poiseuille.analytic_profile_power_law(params)
        rel = float(np.sqrt(np.mean((prof - ana) ** 2)) / ana.max())
        sym = float(np.abs(prof - prof[::-1]).max() / ana.max())
        require(0.01 < ana.max() < 0.05 and rel < 0.04,
                f"power-law gate n {n}: RMSE {rel} of u_max {ana.max()}")
        print(f"domain gate power-law channel 16x24 n {n} f32, {steps} "
              f"steps: RMSE {100 * rel:.3f}% of u_max {ana.max():.5f} (gate "
              f"4%), asymmetry {sym:.1e} of u_max")
    n, U = 64, 0.1
    params = cavity_params(n=n, re=100.0, u=U)
    _, u = run(params, 30000)
    ux, uy = u
    L = n - 1.0
    ucl = 0.5 * (ux[:, n // 2 - 1] + ux[:, n // 2]) / U
    vcl = 0.5 * (uy[n // 2 - 1, :] + uy[n // 2, :]) / U
    k, kmax, kmin = int(np.argmin(ucl)), int(np.argmax(vcl)), \
        int(np.argmin(vcl))
    psi = np.cumsum(ux, axis=0)
    iy, ix = np.unravel_index(np.argmax(np.abs(psi)), psi.shape)
    checks = [-0.24 < ucl[k] < -0.17, 0.35 < k / L < 0.55, ucl[-1] > 0.7,
              0.14 < vcl[kmax] < 0.21, -0.28 < vcl[kmin] < -0.21,
              0.15 < kmax / L < 0.32, 0.72 < kmin / L < 0.90,
              0.6 < iy / L < 0.85, 0.5 < ix / L < 0.75]
    require(all(checks), f"Ghia gate: {checks}")
    print(f"domain gate Ghia Re 100 64^2 f32, 30000 steps: u_min "
          f"{ucl[k]:.4f} U at y/L {k / L:.3f}, v_max {vcl[kmax]:.4f} U at "
          f"x/L {kmax / L:.3f}, v_min {vcl[kmin]:.4f} U at x/L "
          f"{kmin / L:.3f}, vortex at ({ix / L:.3f}, {iy / L:.3f}); all nine "
          "of tests/test_cavity.py's bounds held")
    params = duct_params(nx=8, ny=17, nz=17, body_force=(2e-6, 0.0, 0.0))
    _, u = run(params, 6000)
    prof = u[0][:, :, 0]
    ana = poiseuille.analytic_profile_duct(params)
    rel = float(np.sqrt(np.mean((prof - ana) ** 2)) / ana.max())
    require(rel < 0.02, f"duct gate: RMSE {rel} of u_max")
    print(f"domain gate duct 8x17x17 f32, 6000 steps: RMSE {100 * rel:.3f}% "
          f"of u_max {ana.max():.3e} (gate 2%)")
    print(f"domain gates: {time.perf_counter() - t0:.2f} s")


def domain_phases(dev, card: str) -> list[dict]:
    """Phases 25-29: the kernels' new domains, source and obstacle rule.
    25: 2-D parity (the channel under BGK, MRT and the power law in full,
    its other collisions from the perturbed state; the cavity; the re200
    cylinder with the bounce-back obstacle and with a body force); 26:
    their main paths through the Runner (and the channel's N=3/N=2 run);
    27-28: the duct (BGK in full, the others from the perturbed state),
    the bounce-back sphere and the forced sphere, each Runner at 256^3;
    tpulbm's physics gates; 29: timing. Returns the kernels' JSON
    entries."""
    from tpulbm_torch.ops import step_cuda
    entries = []
    t_all = time.perf_counter()
    # 2-D
    t0 = time.perf_counter()
    cells2 = [("channel " + op, channel_params(**kw), op in CHANNEL_FULL)
              for op, kw in CHANNEL_OPS.items()]
    cells2 += [("cavity", cavity_params(), True),
               ("cylinder bounce-back",
                obstacle_params(False, obstacle_bc="bounce_back"), True),
               ("cylinder source",
                obstacle_params(False, body_force=(OBSTACLE_FORCE, 0.0)),
                True)]
    for label, params, full in cells2:
        cell = Cell(dev, label, params)
        err = cell_parity(cell, full)
        run_dir = OUT_DIR / ("domain_" + label.replace(" ", "_"))
        launches = cell_main_path(dev, cell, run_dir,
                                  mass=params.problem == "cavity")
        if label == "channel bgk":
            # the other depths through the Runner: 311 steps every 150
            d23 = OUT_DIR / "domain_channel_f150"
            _, c23, _ = run_counted(params.replace(
                num_timesteps=311, output_frequency=150,
                output_dir=str(d23)), dev)
            by = step_cuda.collide_stream_blocked.launches_by_library
            require(c23 == {**only(3, 100), 1: 1, 2: 5}
                    and by == {cell.library: {2: 5, 3: 100, 4: 0}},
                    f"channel depths 3 and 2: {c23} {by}")
            launches.update({2: c23[2], 3: c23[3]})
            print(f"domain depths 3 and 2 channel: 311 steps every 150, "
                  f"launches {c23[3]} N=3 + {c23[2]} N=2 + {c23[1]} 1-step "
                  f"of {cell.library}")
        ms, b = cell_timing(cell, card, tuple(sorted(launches)))
        entries += cell_entries(cell, launches, err, ms, b)
        del cell
        torch.cuda.empty_cache()
    print(f"domain phases 25-26 (2-D): {time.perf_counter() - t0:.2f} s")
    # 3-D
    t0 = time.perf_counter()
    cells3 = [("duct " + op, duct_params(**kw), op == "bgk")
              for op, kw in DUCT_OPS.items()]
    cells3 += [("sphere bounce-back",
                obstacle_params(True, obstacle_bc="bounce_back"), True),
               ("sphere source",
                obstacle_params(True, body_force=(OBSTACLE_FORCE, 0.0, 0.0)),
                True)]
    for label, params, full in cells3:
        cell = Cell(dev, label, params)
        err = cell_parity(cell, full)
        run_dir = OUT_DIR / ("domain_" + label.replace(" ", "_"))
        launches = cell_main_path(dev, cell, run_dir, steps=CUT_3D_STEPS)
        shutil.rmtree(run_dir)      # its 256^3 fields, checked
        ms, b = cell_timing(cell, card)
        entries += cell_entries(cell, launches, err, ms, b)
        del cell
        torch.cuda.empty_cache()
    print(f"domain phases 27-28 (3-D): {time.perf_counter() - t0:.2f} s")
    domain_gates(dev)
    print(f"domain phases 25-29: {time.perf_counter() - t_all:.2f} s")
    return entries


# ---- phases 30-34: the 2-D flow on a mesh of shards (the ring builds)

# the meshes of phases 31-32 at re200 and the main path's: scale-8m
# (4096x2048, BASELINE config 4) on 2x2, four shards on one card
MESH_SHAPES = ((4, 1), (1, 4), (2, 2))
MAIN_MESH = (2, 2)
# the rings each launch reads beside the block: rb, rt (depth N, nxl + 2N
# wide) and rl, rr (nyl x N), 9 f32 each, read once
RING_BYTES = 9 * 4


def mesh_builds():
    """(source, mode, variant) of the ring libraries the mesh phases run:
    both D2Q9 sources built with -DTPULBM_RINGS=1 for the BGK cylinder."""
    from tpulbm_torch.ops import step_cuda
    return [(src, "bgk", step_cuda.RINGS)
            for src in ("step_d2q9.cu", "step_d2q9_blocked.cu")]


def card_mesh(shape, dev):
    """A mesh of `shape` with every shard on the one card `dev`."""
    from tpulbm_torch.parallel.mesh import make_mesh
    return make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))


def ring_counts() -> dict:
    """The ring wrapper's launches per (library, depth, shard)."""
    from tpulbm_torch.ops import step_cuda
    return step_cuda.launches_by_shard(step_cuda.collide_stream_rings)


def with_env(env: dict, fn):
    """fn() under the environment variables `env` (tpulbm's dispatch
    switches), restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class MeshCase:
    """One mesh of a problem on the card: its shards' geometry at a depth
    (x rings or not), their kernel launches (the D2Q9 ring builds, or the
    D3Q19 ones for a 3-D problem) and their plain ring steps."""

    def __init__(self, problem, shape, dev, depth: int, x_rings: bool):
        from tpulbm_torch.ops import step_cuda, step_rings_torch
        from tpulbm_torch.parallel import halo, sharded_step
        self.problem, self.shape, self.depth = problem, shape, depth
        self.x_rings = x_rings
        self.mesh = card_mesh(shape, dev)
        self.local = sharded_step.block_shape(problem, self.mesh)
        self.three_d = problem.lattice.D == 3
        self.consts = step_cuda.kernel_constants(problem,
                                                 19 if self.three_d else 9)
        solid = (np.zeros(problem.spatial_shape, bool)
                 if problem.solid is None else problem.solid)
        masks = halo.pad_mask(sharded_step.shard_mask(self.mesh, solid),
                              periodic_x=problem.periodic_x,
                              periodic_y=problem.periodic_y, depth=depth)
        grid = sharded_step.kernel_shards(problem, self.mesh, depth, x_rings,
                                          masks)
        self.shards, self.plains = {}, {}
        for iy, ix in self.mesh.shards():
            o = sharded_step.origin(self.mesh, self.local, iy, ix)
            self.shards[iy, ix] = grid[iy][ix]
            self.plains[iy, ix] = step_rings_torch.make_ring_step(
                problem, o, self.local, depth,
                masks[iy][ix] if problem.solid is not None else None, dev)

    def split(self, f: torch.Tensor):
        from tpulbm_torch.parallel import sharded_step
        return sharded_step.split(self.mesh, f)

    def rings(self, blocks):
        from tpulbm_torch.parallel import halo
        return halo.exchange(blocks, eq_ring=self.problem.ghost_ring_values(),
                             depth=self.depth,
                             periodic_x=self.problem.periodic_x,
                             periodic_y=self.problem.periodic_y,
                             x_rings=self.x_rings)

    def launch(self, block, out, rings, idx, rows=None):
        from tpulbm_torch.ops import step_cuda
        if self.three_d:
            return step_cuda.collide_stream_rings_3d(
                block, out, rings, self.shards[idx], self.consts, self.depth)
        return step_cuda.collide_stream_rings(
            block, out, rings, self.shards[idx], self.consts, self.depth,
            rows=rows)

    def step_all(self, blocks, rings=None, ranged: bool = False):
        """One launch of every shard (three ranged ones with `ranged`)."""
        rings = self.rings(blocks) if rings is None else rings
        nyl, e = self.local[-2], self.depth + 1
        outs = []
        for iy, row in enumerate(blocks):
            orow = []
            for ix, b in enumerate(row):
                out = torch.empty_like(b)
                if ranged:
                    self.launch(b, out, (None,) * 4, (iy, ix),
                                rows=(e, nyl - e))
                    self.launch(b, out, rings[iy][ix], (iy, ix), rows=(0, e))
                    self.launch(b, out, rings[iy][ix], (iy, ix),
                                rows=(nyl - e, nyl))
                else:
                    self.launch(b, out, rings[iy][ix], (iy, ix))
                orow.append(out)
            outs.append(orow)
        return outs


def gather(blocks) -> torch.Tensor:
    from tpulbm_torch.parallel import sharded_step
    return sharded_step.gather(blocks)


def ring_parity(problem, f, shape, dev, depth, x_rings, one_device,
                ranged=False, sep_check=False,
                case=None) -> tuple[float, float | None]:
    """Phase 31 (and 37, 43, 51) on one mesh, depth and state: every
    shard's launch against its plain ring step (the N-step tolerance), the
    gathered result bitwise against the one-device kernel's; with
    sep_check, rings of the frozen equilibrium on the shard edges must
    miss the plain step by SEPARATION tolerances. Returns (max error, the
    separation in tolerances or None; sep_text words it). `case`: the
    MeshCase of the mesh and depth, built here if not given."""
    from tpulbm_torch.parallel import halo
    case = case or MeshCase(problem, shape, dev, depth, x_rings)
    blocks = case.split(f)
    rings = case.rings(blocks)
    got = case.step_all(blocks, rings, ranged=ranged)
    tol = n_step_tol(depth)
    err = 0.0
    for idx, plain in case.plains.items():
        rb, rt, rl, rr = rings[idx[0]][idx[1]]
        want = plain(blocks[idx[0]][idx[1]], rb, rt, rl, rr)
        torch.testing.assert_close(got[idx[0]][idx[1]], want, **tol)
        err = max(err, float((got[idx[0]][idx[1]] - want).abs().max()))
    one = one_device(f)
    whole = gather(got)
    torch.cuda.synchronize()
    require(torch.equal(whole, one),
            f"mesh {shape} N={depth}: {float((whole - one).abs().max())} off "
            "the one-device kernel")
    sep = None
    if sep_check:
        eq = problem.ghost_ring_values()
        flat = [[tuple(None if r is None else halo._eq_block(eq, r, r.shape)
                       for r in rs) for rs in row] for row in rings]
        bad = case.step_all(blocks, flat, ranged=ranged)
        sep = 0.0
        for idx, plain in case.plains.items():
            rb, rt, rl, rr = rings[idx[0]][idx[1]]
            want = plain(blocks[idx[0]][idx[1]], rb, rt, rl, rr)
            d = bad[idx[0]][idx[1]] - want
            sep = max(sep, float((d.abs() / (tol["atol"] + tol["rtol"]
                                             * want.abs())).max()))
        require(sep > SEPARATION, f"mesh {shape} N={depth}: equilibrium "
                f"rings only {sep:.1f}x the tolerance off")
    del case, blocks, rings, got, whole
    torch.cuda.empty_cache()
    return err, sep


def sep_text(sep: float | None) -> str:
    """ring_parity's separation as its line's closing words."""
    return ("" if sep is None else
            f", equilibrium rings {sep:.0f}x the tolerance off")


def mesh_plan_launches(problem, mesh, lengths) -> dict:
    """The launches per (library, depth, shard) of chunks of `lengths`
    steps on `mesh`, from the chunk plan (sharded_step.plan)."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.parallel import sharded_step
    lib = step_cuda.kernel_constants(problem).library
    want: dict = {}
    for n in lengths:
        mode, depth = sharded_step.plan(problem, mesh, n)
        per = n // depth * (3 if mode == "overlap" else 1)
        for idx in mesh.shards():
            key = (lib, depth, idx)
            want[key] = want.get(key, 0) + per
    return want


def runner_chunks(params) -> list[int]:
    """The chunk lengths the Runner's loop steps for `params` when no
    super-chunk fits (runner.py's tail: an interval at a time, the last
    one stopped a step short for the final fields)."""
    t, out, freq = 0, [], params.output_frequency
    t_fields = params.num_timesteps - 1
    while t < params.num_timesteps:
        n = min(freq - t % freq, params.num_timesteps - t)
        if t < t_fields:
            n = min(n, t_fields - t)
        out.append(n)
        t += n
    return out


def mesh_phases(dev, card: str) -> list[dict]:
    """Phases 30-34: the ring builds on the card. Returns their kernels'
    JSON entries."""
    from tpulbm_torch.config import PRESETS
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.runner import Runner
    from tpulbm_torch.utils import cuda_build

    t_all = time.perf_counter()
    for (src, mode, variant) in mesh_builds():
        lib = cuda_build.load(src, step_cuda.build_defines(mode, variant))
        print(f"build: {src} {step_cuda.build_defines(mode, variant)} "
              f"(the ring build) in {lib.build_seconds:.2f} s "
              f"({ptxas_summary(lib.log)})")

    # phase 30: the ring builds on a (1,1) mesh against today's builds
    t0 = time.perf_counter()
    params = PRESETS["re200"].replace(precision="f32", enable_vtk=False)
    problem = make_problem(params)
    f0 = initial_state(problem, dev)
    fp = perturbed(problem, f0)
    one = {1: step_cuda.make_local_step_cuda(problem, dev)}
    for n in DEPTHS:
        one[n] = step_cuda.make_local_step_cuda_blocked(problem, dev, n)
    for depth in (1, *DEPTHS):
        for x_rings in (False, True):
            case = MeshCase(problem, (1, 1), dev, depth, x_rings)
            for f in (f0, fp):
                got = gather(case.step_all(case.split(f)))
                want = one[depth](f, torch.empty_like(f))
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"(1,1) ring build N={depth} x_rings={x_rings}: "
                        f"{float((got - want).abs().max())} off today's")
    print(f"mesh (1,1): the ring builds at re200, 1-step and N=2,3,4, with "
          f"and without x rings, from the initial and the perturbed state: "
          f"bitwise equal to today's builds ({time.perf_counter() - t0:.2f}"
          f" s)")

    # phase 31: one launch per shard on each mesh against the plain ring
    # step, bitwise against one device, the ranged launches, separation
    t0 = time.perf_counter()
    for shape in MESH_SHAPES:
        x_rings = shape[1] != 1
        for depth in (1, *DEPTHS):
            for name, f in (("initial", f0), ("perturbed", fp)):
                err, sep = ring_parity(
                    problem, f, shape, dev, depth, x_rings,
                    lambda g, d=depth: one[d](g, torch.empty_like(g)),
                    sep_check=name == "perturbed")
                print(f"mesh {shape} N={depth} from the {name} state: every "
                      f"shard within {err:.3e} of its plain ring step "
                      f"(rtol {n_step_tol(depth)['rtol']:.0e}, atol "
                      f"{n_step_tol(depth)['atol']:.0e}), the mesh bitwise "
                      f"equal to one device{sep_text(sep)}")
    for depth in (1, 4):
        for name, f in (("initial", f0), ("perturbed", fp)):
            err, sep = ring_parity(
                problem, f, (4, 1), dev, depth, False,
                lambda g, d=depth: one[d](g, torch.empty_like(g)),
                ranged=True, sep_check=name == "perturbed")
            print(f"mesh (4, 1) ranged N={depth} (interior, bottom, top) "
                  f"from the {name} state: within {err:.3e} of the plain "
                  f"ring step, bitwise equal to one device{sep_text(sep)}")
    print(f"mesh parity: {time.perf_counter() - t0:.2f} s")

    # phase 32: 280 steps (and 40-42 at the other depths) on each mesh and
    # mode, counted, bitwise against the one-device chunk
    t0 = time.perf_counter()
    runs = [((4, 1), {}, 280, "rows"), ((1, 4), {}, 280, "tiled"),
            ((2, 2), {}, 280, "tiled"),
            ((4, 1), {"TPULBM_HALO_OVERLAP": "1"}, 280, "overlap"),
            ((4, 1), {"TPULBM_NO_FUSED2": "1"}, 40, "rows"),
            ((4, 1), {"TPULBM_SUBSTEPS": "2"}, 40, "rows"),
            ((4, 1), {"TPULBM_HALO_OVERLAP": "1", "TPULBM_NO_FUSED2": "1"},
             40, "overlap"),
            ((2, 2), {"TPULBM_NO_FUSED2": "1"}, 42, "tiled"),
            ((2, 2), {"TPULBM_SUBSTEPS": "2"}, 42, "tiled"),
            ((2, 2), {"TPULBM_SUBSTEPS": "3"}, 42, "tiled")]
    launches = {}
    for shape, env, steps, kind in runs:
        mesh = card_mesh(shape, dev)

        def run_both(mesh=mesh, steps=steps):
            chunk = sharded_step.make_chunk_fn(problem, mesh, steps)
            ref = step_cuda_chunk(problem, dev, steps)
            blocks = sharded_step.split(mesh, f0)
            want = ref(f0.clone())
            reset_counts()
            got = chunk(blocks)
            torch.cuda.synchronize()
            return chunk, got, want, ring_counts(), read_counts()

        chunk, got, want, counts, others = with_env(env, run_both)
        whole = gather(got)
        same = torch.equal(whole, want)
        require(same, f"mesh {shape} {env}: {steps} steps "
                f"{float((whole - want).abs().max())} off one device")
        plan = with_env(env, lambda mesh=mesh, steps=steps:
                        mesh_plan_launches(problem, mesh, [steps]))
        require(counts == plan and others == only(1, 0)
                and chunk.mode == kind,
                f"mesh {shape} {env}: {chunk.mode} launches {counts} "
                f"{others}, not {kind} {plan}")
        depth = chunk.substeps
        launches[kind, depth] = sum(counts.values())
        print(f"mesh {shape} {env or ''} {steps} steps: {chunk.mode} at "
              f"N={depth}, {sum(counts.values())} ring launches "
              f"({len(counts)} shards x {steps // depth * (3 if chunk.mode == 'overlap' else 1)}),"
              f" bitwise equal to the one-device chunk")
    print(f"mesh runs: {time.perf_counter() - t0:.2f} s")

    # phase 33: the main path, scale-8m on 2x2 through the Runner
    t0 = time.perf_counter()
    p8 = PRESETS["scale-8m"].replace(precision="f32", enable_vtk=False)
    problem8 = make_problem(p8)
    mesh8 = card_mesh(MAIN_MESH, dev)
    d_mesh = OUT_DIR / "scale8m_2x2"
    d_one = OUT_DIR / "scale8m_1x1"
    pm = p8.replace(mesh_shape=MAIN_MESH, output_dir=str(d_mesh))
    runner = Runner(pm, devices=[dev] * 4, verbose=False)
    reset_counts()
    t1 = time.perf_counter()
    result = runner.run()
    wall = time.perf_counter() - t1
    counts, others = ring_counts(), read_counts()
    require(result.success, "the scale-8m mesh run failed")
    chunks = runner_chunks(pm)
    plan = mesh_plan_launches(problem8, mesh8, chunks)
    require(counts == plan and others == only(1, 0),
            f"scale-8m 2x2: launches {counts} {others}, not {plan}")
    main_launches = {}
    for (lib, depth, idx), n in counts.items():
        main_launches[depth] = main_launches.get(depth, 0) + n
    one_run = Runner(p8.replace(output_dir=str(d_one)), device=dev,
                     verbose=False).run()
    require(one_run.success, "the scale-8m one-device run failed")
    steps_all = list(range(0, p8.num_timesteps, p8.output_frequency))
    fm, fo = check_forces(d_mesh, steps_all), check_forces(d_one, steps_all)
    np.testing.assert_allclose(fm[:, 1:3], fo[:, 1:3], **FORCES_TOL)
    vm = np.loadtxt(d_mesh / "velocity_field.csv", delimiter=",",
                    skiprows=1, dtype=np.float64)
    vo = np.loadtxt(d_one / "velocity_field.csv", delimiter=",",
                    skiprows=1, dtype=np.float64)
    require(vm.shape == (p8.nx * p8.ny, 6), f"velocity field {vm.shape}")
    np.testing.assert_allclose(vm, vo, rtol=1e-4, atol=5e-6)
    dv = float(np.abs(vm - vo).max())
    del vm, vo
    print(f"main path: scale-8m {p8.nx}x{p8.ny} f32 on a 2x2 mesh of "
          f"{p8.ny // 2}x{p8.nx // 2} shards on one card, 2000 steps every "
          f"500 (chunks {chunks}): launches per library, depth and shard "
          + ", ".join(f"{lib} N={d} {idx}: {n}" for (lib, d, idx), n in
                      sorted(counts.items()))
          + f" (from the chunk plan), 0 of another kernel; "
          f"{result.host_fetches} host fetches in the loop, {wall:.2f} s "
          f"wall, runner {result.mlups:.1f} MLUPS (one device "
          f"{one_run.mlups:.1f}); forces.csv within rtol 1e-4 / atol 5e-6 "
          f"(max diff {float(np.abs(fm[:, 1:3] - fo[:, 1:3]).max()):.3e}) "
          f"and velocity_field.csv (max diff {dv:.3e}) of the one-device "
          f"run ({time.perf_counter() - t0:.2f} s)")

    # phase 34: timing, CUDA events, in turns
    t0 = time.perf_counter()
    order = ["today", "rings"]
    for depth in (1, *DEPTHS):
        case = MeshCase(problem, (1, 1), dev, depth, False)
        rings = case.rings(case.split(f0))
        runs_ = {"today": lambda f, m, d=depth: kernel_chunk(one[d], f, m // d),
                 "rings": lambda f, m, case=case, rings=rings: kernel_chunk(
                     lambda g, o: case.launch(g, o, rings[0][0], (0, 0)),
                     f, m // case.depth)}
        times = {k: [] for k in order}
        for which in order + order[::-1]:
            times[which].append(ms_per_step(runs_[which], f0, 2400))
        ms = {k: min(v) for k, v in times.items()}
        print(f"timing (1,1) re200 N={depth} on {card}: today's build "
              f"{ms['today']:.5f} ms/step, the ring build {ms['rings']:.5f} "
              f"({100 * (ms['rings'] / ms['today'] - 1):+.2f}%)")
    f8 = initial_state(problem8, dev)
    fp8 = perturbed(problem8, f8)
    entries = []
    timed = [("tiled", (2, 2), 1), ("tiled", (2, 2), 2), ("tiled", (2, 2), 3),
             ("tiled", (2, 2), 4), ("rows", (4, 1), 1), ("rows", (4, 1), 2),
             ("rows", (4, 1), 4), ("overlap", (4, 1), 1),
             ("overlap", (4, 1), 4)]
    for kind, shape, depth in timed:
        case = MeshCase(problem8, shape, dev, depth, kind == "tiled")
        # every shard's launch (the overlap mode's three) from the
        # perturbed state against its plain ring step at this shape: the
        # line's max_abs_err
        pblocks = case.split(fp8)
        prings = case.rings(pblocks)
        got = case.step_all(pblocks, prings, ranged=kind == "overlap")
        tol = n_step_tol(depth)
        err = 0.0
        for (iy, ix), plain in case.plains.items():
            want = plain(pblocks[iy][ix], *prings[iy][ix])
            torch.testing.assert_close(got[iy][ix], want, **tol)
            err = max(err, float((got[iy][ix] - want).abs().max()))
        del pblocks, prings, got, want
        blocks = case.split(f8)
        rings = case.rings(blocks)
        b, r = blocks[0][0], rings[0][0]
        nyl, nxl = case.local
        e = depth + 1

        def launch_one(g, o, case=case, r=r, kind=kind, nyl=nyl, e=e):
            if kind == "overlap":
                case.launch(g, o, (None,) * 4, (0, 0), rows=(e, nyl - e))
                case.launch(g, o, r, (0, 0), rows=(0, e))
                case.launch(g, o, r, (0, 0), rows=(nyl - e, nyl))
                return o
            return case.launch(g, o, r, (0, 0))

        plain = case.plains[0, 0]
        runs_ = {"plain": lambda g, m, plain=plain, r=r: [
                     plain(g, *r) for _ in range(m // depth)][-1],
                 "kernel": lambda g, m, depth=depth, fn=launch_one:
                     kernel_chunk(fn, g, m // depth)}
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            m = 4 * depth if which == "plain" else 1200
            times[which].append(ms_per_step(runs_[which], b, m,
                                            warm=depth if which == "plain"
                                            else 20))
        ms = {k: min(v) for k, v in times.items()}
        cells = nyl * nxl
        hx = depth if kind == "tiled" else 0
        ring_bytes = RING_BYTES * 2 * depth * (nxl + 2 * hx) + \
            (RING_BYTES * 2 * nyl * depth if kind == "tiled" else 0)
        bnd = bound_of(STEP_BYTES["d2q9"], STEP_FLOPS["d2q9"], cells, depth)
        bnd["bound_ms"] += 1e3 * ring_bytes / depth / HBM_BYTES_PER_S
        print(f"scale-8m mesh {shape} {kind} N={depth}: every shard within "
              f"{err:.3e} of its plain ring step from the perturbed state "
              f"(rtol {tol['rtol']:.0e}, atol {tol['atol']:.0e})")
        print(f"timing scale-8m shard {nyl}x{nxl} ({kind}, mesh {shape}) "
              f"N={depth} on {card}: kernel {ms['kernel']:.5f} ms/step "
              f"({cells / ms['kernel'] / 1e3:.1f} MLUPS, "
              f"{100 * bnd['bound_ms'] / ms['kernel']:.1f}% of its "
              f"{bnd['bound_ms']:.5f} ms bound), plain ring step "
              f"{ms['plain']:.5f} ms/step")
        n_launch = launches.get((kind, depth))
        if kind == "tiled" and depth in main_launches:
            n_launch = main_launches[depth]
        if n_launch:
            entries.append({
                "name": f"d2q9_rings_{kind}" + (f"_n{depth}" if depth > 1
                                                else ""),
                "route": "cuda",
                "source": (step_cuda.KERNEL_SOURCE if depth == 1
                           else step_cuda.BLOCKED_SOURCE),
                "replaces": step_cuda.rings_replaces(kind, depth),
                "launches": n_launch, "max_abs_err": err,
                "ms": ms["kernel"], "plain_ms": ms["plain"], **bnd})
        del case, blocks, rings, b, r
        torch.cuda.empty_cache()
    print(f"mesh timing: {time.perf_counter() - t0:.2f} s; mesh phases "
          f"{time.perf_counter() - t_all:.2f} s")
    return entries


# ---- phases 35-40: the periodic boxes, Kolmogorov forcing, the passive
# scalar

# bench.py's --periodic, --kolmogorov and thermal rows at the main path's
# width: Taylor-Green (tau 0.8, u0 0.04), Kolmogorov (n 4, tau 0.8,
# u0 0.05: F0 = u0 nu kappa^2 = 1.2e-5), the passive scalar stirred by
# the Taylor-Green flow (u0 0.04, thermal_tau 0.5704)
BOX_NX, BOX_NY = 2048, 512
# Mass in a closed box: the pull and the sources conserve it, but every
# collision relaxes toward equilibria whose float32 weights sum to 1 + e
# times the cell's density as float32 sums it: e = 2^-27 for D2Q9
# (MP_WEIGHT_EXCESS) and 2^-25 for D2Q5 (1/3 + 4/6 rounded), so a step
# adds at most about e/tau of the flow's mass and e/tau_g of the
# scalar's (2.1e-5 and 1.2e-4 over 2240 steps at tau 0.8 and 0.5704).
# How much of it shows depends on how the density's own rounding falls
# (none at rest, where the float32 density sums to 1 exactly; 0.65-1.06
# of it in CPU runs of the plain step at 64x32): the gate holds the drift
# from t = 0 between -BOX_MASS_TOL and BOX_MASS_SPAN times that term plus
# BOX_MASS_TOL, so a lost or doubled seam row (1/ny of the mass a step)
# fails it by orders of magnitude.
D2Q5_WEIGHT_EXCESS = float(np.array([1 / 3] + [1 / 6] * 4, np.float32)
                           .astype(np.float64).sum() - 1)
BOX_MASS_TOL = 1e-6
BOX_MASS_SPAN = 1.25


def box_params(name: str, nx: int = BOX_NX, ny: int = BOX_NY, **kw):
    """One of the periodic problems at bench.py's rows, f32, no VTK."""
    from tpulbm_torch.config import SimulationParams
    d = dict(problem=name, nx=nx, ny=ny, tau=0.8,
             inlet_velocity=0.05 if name == "kolmogorov" else 0.04,
             kolmogorov_n=4, periodic_x=True, cylinder_radius=0.0,
             precision="f32", enable_vtk=False)
    if name == "passive-scalar":
        d["thermal_tau"] = 0.5704
    d.update(kw)
    return SimulationParams(**d)


def x_force_problem(params):
    """Kolmogorov's problem with its force turned along x, F_y = F0
    cos(kappa x) (tpulbm's tests/test_kolmogorov.py:239)."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.models.base import ForceProfile
    from tpulbm_torch.models.periodic2d import kolmogorov_f0
    kx = 2.0 * np.pi * params.kolmogorov_n / params.nx
    f0 = kolmogorov_f0(params)
    return dataclasses.replace(
        make_problem(params), force_profile=ForceProfile(
            "x", lambda x: (0.0, f0 * torch.cos(kx * x))))


def box_mass_gate(label: str, m: float, m0: float, steps: int,
                  excess: float, tau: float) -> str:
    """Raise unless the mass m after `steps` steps lies between m0 and the
    most the float32 weights' term can add (BOX_MASS_SPAN times it),
    within BOX_MASS_TOL of m0 either way."""
    drift = m / m0 - 1.0
    term = (1.0 + excess / tau) ** steps - 1.0
    require(-BOX_MASS_TOL < drift < BOX_MASS_SPAN * term + BOX_MASS_TOL,
            f"{label}: mass drift {drift:.3e} outside [-{BOX_MASS_TOL}, "
            f"{BOX_MASS_SPAN} x {term:.3e} + {BOX_MASS_TOL}] (the float32 "
            "weights' term)")
    return (f"{label} mass drift {drift:.3e} from t = 0, "
            f"{drift / term:.3f} of the float32 weights' {term:.3e} (gate "
            f"-{BOX_MASS_TOL} to {BOX_MASS_SPAN}x it + {BOX_MASS_TOL})")


def box_mass(problem, dev, steps: int = 2240) -> str:
    """The mass gates after `steps` steps of the kernels' chunk (the Runner's
    depth, 140 steps a chunk) from the initial state: the flow's and, with
    a scalar, the scalar's (box_mass_gate)."""
    from tpulbm_torch.stepper import make_chunk_fn
    f0 = initial_state(problem, dev)
    chunk = make_chunk_fn(problem, dev, 140)
    f = f0.clone()
    for _ in range(steps // 140):
        f = chunk(f)
    q = problem.lattice.Q
    sums = [(float(torch.sum(f[:q], dtype=torch.float64)),
             float(torch.sum(f0[:q], dtype=torch.float64)))]
    if problem.thermal is not None:
        sums.append((float(torch.sum(f[q:], dtype=torch.float64)),
                     float(torch.sum(f0[q:], dtype=torch.float64))))
    text = [box_mass_gate("flow", *sums[0], steps,
                          weight_excess(problem.lattice), problem.params.tau)]
    if problem.thermal is not None:
        text.append(box_mass_gate("scalar", *sums[1], steps,
                                  D2Q5_WEIGHT_EXCESS, problem.thermal.tau_g))
    return "; ".join(text)


def box_main_path(dev, cell: Cell, run_dir: Path) -> dict:
    """Phase 36 on a box cell: cell_main_path (2240 steps every 140,
    exactly 525 N=4 and 140 1-step launches of the cell's library), then
    the mass gates after the same 2240 kernel steps."""
    launches = cell_main_path(dev, cell, run_dir)
    print(f"box mass {cell.label} after 2240 kernel steps: "
          + box_mass(cell.problem, dev))
    return launches


def box_mesh(dev, problem, f0) -> dict:
    """Phase 37 on one problem: one launch a shard on (2,2), (4,1), (1,4)
    at N = 1 and 4 from the perturbed state against the plain ring step
    and bitwise against one device, equilibrium rings > SEPARATION
    tolerances off; 280 steps on each mesh, counted, bitwise against the
    one-device chunk; the Runner on 2x2 (devices=[cuda:0]*4), 560 steps
    every 140, counted, its artifacts byte-identical to one device's.
    Returns the ring launches of that run by depth."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.runner import Runner
    label = problem.params.problem
    one = {1: step_cuda.make_local_step_cuda(problem, dev),
           4: step_cuda.make_local_step_cuda_blocked(problem, dev, 4)}
    fp = perturbed(problem, f0)
    for shape in MESH_SHAPES:
        for depth in (1, 4):
            err, sep = ring_parity(
                problem, fp, shape, dev, depth, shape[1] != 1,
                lambda g, d=depth: one[d](g, torch.empty_like(g)),
                sep_check=True)
            print(f"box mesh {label} {shape} N={depth} from the perturbed "
                  f"state: every shard within {err:.3e} of its plain ring "
                  f"step, the mesh bitwise equal to one device"
                  f"{sep_text(sep)}")
        mesh = card_mesh(shape, dev)
        chunk = sharded_step.make_chunk_fn(problem, mesh, 280)
        want = step_cuda_chunk(problem, dev, 280)(fp.clone())
        reset_counts()
        got = gather(chunk(sharded_step.split(mesh, fp)))
        torch.cuda.synchronize()
        counts = ring_counts()
        plan = mesh_plan_launches(problem, mesh, [280])
        require(torch.equal(got, want) and counts == plan,
                f"box mesh {label} {shape}: 280 steps "
                f"{float((got - want).abs().max())} off one device, "
                f"launches {counts} not {plan}")
        print(f"box mesh {label} {shape} 280 steps: {chunk.mode} at "
              f"N={chunk.substeps}, {sum(counts.values())} ring launches, "
              "bitwise equal to the one-device chunk")
        del got, want
    params = problem.params.replace(num_timesteps=560, output_frequency=140)
    d_mesh = OUT_DIR / f"box_{label}_2x2"
    d_one = OUT_DIR / f"box_{label}_1x1"
    pm = params.replace(mesh_shape=MAIN_MESH, output_dir=str(d_mesh))
    runner = Runner(pm, devices=[dev] * 4, verbose=False)
    reset_counts()
    result = runner.run()
    counts, others = ring_counts(), read_counts()
    plan = mesh_plan_launches(problem, card_mesh(MAIN_MESH, dev),
                              runner_chunks(pm))
    require(result.success and counts == plan and others == only(1, 0),
            f"box mesh runner {label}: launches {counts} {others}, not "
            f"{plan}")
    require(Runner(params.replace(output_dir=str(d_one)), device=dev,
                   verbose=False).run().success, "one-device run failed")
    require(same_files(d_mesh, d_one, ["velocity_field.csv"]),
            f"box mesh runner {label}: velocity_field.csv differs from one "
            "device's")
    by_depth = {}
    for (_, depth, _), n in counts.items():
        by_depth[depth] = by_depth.get(depth, 0) + n
    print(f"box mesh runner {label} {params.nx}x{params.ny} on 2x2 (one "
          f"card), 560 steps every 140: ring launches "
          + ", ".join(f"N={d}: {n}" for d, n in sorted(by_depth.items()))
          + f" (the chunk plan's), 0 of another kernel, velocity_field.csv "
          f"byte-identical to one device's, runner {result.mlups:.1f} MLUPS")
    return by_depth


def box_ring_timing(problem, dev, card: str, depth: int, fp):
    """One shard's ring launch of the 2x2 mesh (x rings) at `depth`
    against its plain ring step, in turns, from the perturbed state fp,
    every shard's launch held against its plain ring step first. Returns
    (max error, {kernel, plain} ms, bound)."""
    case = MeshCase(problem, MAIN_MESH, dev, depth, True)
    blocks = case.split(fp)
    rings = case.rings(blocks)
    got = case.step_all(blocks, rings)
    err = 0.0
    for (iy, ix), plain in case.plains.items():
        want = plain(blocks[iy][ix], *rings[iy][ix])
        torch.testing.assert_close(got[iy][ix], want, **n_step_tol(depth))
        err = max(err, float((got[iy][ix] - want).abs().max()))
    b, r = blocks[0][0], rings[0][0]
    plain = case.plains[0, 0]
    runs_ = {"plain": lambda g, m: [plain(g, *r) for _ in range(m // depth)
                                    ][-1],
             "kernel": lambda g, m: kernel_chunk(
                 lambda x, o: case.launch(x, o, r, (0, 0)), g, m // depth)}
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        m = 4 * depth if which == "plain" else 1200
        times[which].append(ms_per_step(runs_[which], b, m,
                                        warm=depth if which == "plain"
                                        else 20))
    ms = {k: min(v) for k, v in times.items()}
    nyl, nxl = case.local
    ring_bytes = RING_BYTES * 2 * depth * (nxl + 2 * depth) + \
        RING_BYTES * 2 * nyl * depth
    flops = STEP_FLOPS["d2q9"] + (9 if problem.force_profile else 0)
    bnd = bound_of(9 * 4 * 2, flops, nyl * nxl, depth)
    bnd["bound_ms"] += 1e3 * ring_bytes / depth / HBM_BYTES_PER_S
    print(f"timing box shard {nyl}x{nxl} ({problem.params.problem}, 2x2, "
          f"x rings) N={depth} on {card}: kernel {ms['kernel']:.5f} ms/step "
          f"({nyl * nxl / ms['kernel'] / 1e3:.1f} MLUPS, "
          f"{100 * bnd['bound_ms'] / ms['kernel']:.1f}% of its "
          f"{bnd['bound_ms']:.5f} ms bound), plain ring step "
          f"{ms['plain']:.5f} ms/step; every shard within {err:.3e} of its "
          "plain ring step from the perturbed state")
    return err, ms, bnd


def scalar_phases(dev, card: str) -> dict:
    """Phase 38: the passive scalar through the thermal kernel (wall flags
    off): one step against the plain thermal step at 2048x512 from the
    initial state, after 500 plain steps and from the perturbed state, at
    rest and stirred; 280 steps; the Runner, 2240 steps every 140: exactly
    2240 thermal launches, a finite scalar_variance.csv in tpulbm's layout
    and no nusselt.csv, the flow's and the scalar's mass after the float32
    weights' terms; timing. Returns the kernel's JSON entry."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_thermal, step_thermal_cuda
    errs = []
    for u0 in (0.0, 0.04):
        problem = make_problem(box_params("passive-scalar",
                                          inlet_velocity=u0))
        kstep = step_thermal_cuda.make_local_step_thermal_cuda(problem, dev)
        pstep = step_thermal.make_step_thermal(problem, dev)
        s0 = initial_state(problem, dev)
        states = [("initial", s0),
                  ("500 plain steps", plain_chunk(pstep, s0.clone(), 500)),
                  ("perturbed", perturbed(problem, s0))]
        line = []
        for name, s in states:
            got = kstep(s, torch.empty_like(s))
            want = pstep(s)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **ONE_STEP_TOL)
            errs.append(float((got - want).abs().max()))
            line.append(f"{errs[-1]:.3e} ({name})")
        sk = kernel_chunk(kstep, s0.clone(), 280)
        sp = plain_chunk(pstep, s0.clone(), 280)
        torch.cuda.synchronize()
        err_280 = float((sk - sp).abs().max())
        require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
                f"scalar u0 {u0}: 280-step drift {err_280}")
        print(f"scalar parity {BOX_NX}x{BOX_NY} u0 {u0}: 1 step max abs err "
              + ", ".join(line) + f" (rtol 5e-6, atol 1e-7); 280 steps "
              f"{err_280:.3e} (bound {DRIFT_280_BOUND})")
        del states, sk, sp
    run_dir = OUT_DIR / "passive_scalar_2048x512"
    params = box_params("passive-scalar", num_timesteps=2240,
                        output_frequency=140, output_dir=str(run_dir))
    result, counts, wall = run_counted(params, dev)
    require(counts == only("thermal", 2240),
            f"scalar launch counts {counts}, not 2240 thermal and 0 others")
    text = (run_dir / "scalar_variance.csv").read_text().splitlines()
    require(text[0] == "timestep,scalar_variance" and len(text) == 17
            and all(re.fullmatch(r"\d+,\d\.\d{8}e[-+]\d\d", ln)
                    for ln in text[1:]),
            f"scalar_variance.csv: {text[:3]}")
    var = np.array([float(ln.split(",")[1]) for ln in text[1:]])
    require(bool(np.isfinite(var).all()) and bool(np.all(np.diff(var) < 0)),
            f"scalar variance not finite and falling: {var}")
    require(not (run_dir / "nusselt.csv").exists()
            and not (run_dir / "forces.csv").exists(),
            "the scalar wrote nusselt.csv or forces.csv")
    problem = make_problem(params)
    mass = box_mass(problem, dev)
    print(f"scalar main path: passive-scalar {BOX_NX}x{BOX_NY} f32 (u0 0.04, "
          f"thermal_tau 0.5704), 2240 steps, launches {counts['thermal']} "
          f"thermal and 0 others, {result.host_fetches} host fetches in the "
          f"loop, {wall:.2f} s wall, runner {result.mlups:.1f} MLUPS; "
          f"scalar_variance.csv 16 finite falling rows ({var[0]:.6e} to "
          f"{var[-1]:.6e}), final stat {result.stats['scalar_variance']:.6e},"
          f" no nusselt.csv; {mass}")
    kstep = step_thermal_cuda.make_local_step_thermal_cuda(problem, dev)
    pstep = step_thermal.make_step_thermal(problem, dev)
    s0 = initial_state(problem, dev)
    runs = {"plain": (lambda f, n: plain_chunk(pstep, f, n),
                      PLAIN_2D_STEPS),
            "kernel": (lambda f, n: kernel_chunk(kstep, f, n), 2400)}
    times = {k: [] for k in runs}
    for which in ["plain", "kernel", "kernel", "plain"]:
        run, steps = runs[which]
        times[which].append(ms_per_step(run, s0, steps, PLAIN_WARM
                                        if which == "plain" else 20))
    ms = {k: min(v) for k, v in times.items()}
    cells = BOX_NX * BOX_NY
    b = bound("thermal", cells)
    print(f"scalar timing at {BOX_NX}x{BOX_NY} on {card}, ms/step (MLUPS): "
          f"plain "
          f"{ms['plain']:.5f} ({cells / ms['plain'] / 1e3:.1f}); kernel "
          f"{ms['kernel']:.5f} ({cells / ms['kernel'] / 1e3:.1f}, runs "
          f"{[round(v, 6) for v in times['kernel']]}), "
          f"{100 * b['bound_ms'] / ms['kernel']:.1f}% of {b['bound_ms']:.5f}"
          f" ({b['bound_by']})")
    return {"name": "thermal_collide_stream[passive_scalar]",
            "route": "cuda", "source": step_thermal_cuda.SOURCE,
            "replaces": step_thermal_cuda.REPLACES,
            "launches": counts["thermal"], "max_abs_err": max(errs),
            "ms": ms["kernel"], "plain_ms": ms["plain"], **b}


def box_gates(dev) -> None:
    """Phase 39: tpulbm's physics gates through the kernels in f32, at its
    sizes and thresholds: Taylor-Green's energy decay recovers nu within
    0.5% (tests/test_periodic.py:55-74: 64^2, 12 x 150 steps); Kolmogorov's
    laminar profile a fixed point within 1.5% and its spin-up from rest
    the linear solution within 2% (tests/test_kolmogorov.py:42-88: 32^2,
    n 1, u0 0.01); the scalar's pure diffusion at the exact rate within
    1e-3, uniform advection's phase within 2e-3 and amplitude within
    5e-3, stirring at least halving the variance against diffusion
    (tests/test_passive_scalar.py:41-111); the shear-layer preset (128^2,
    Re 30,000, regularized, 12,000 steps) finite through the Runner."""
    from tpulbm_torch import physics
    from tpulbm_torch.lattice import D2Q9
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.models.periodic2d import kolmogorov_kappa
    from tpulbm_torch.ops import step_thermal
    from tpulbm_torch.config import PRESETS
    from tpulbm_torch.stepper import make_chunk_fn

    t0 = time.perf_counter()

    def start(problem):
        return initial_state(problem, dev)

    def advance(problem, f, steps):
        out = make_chunk_fn(problem, dev, steps)(f)
        torch.cuda.synchronize()
        require(bool(physics.is_stable(out)),
                f"gate {problem.params.problem} unstable")
        return out

    # Taylor-Green viscosity
    params = box_params("taylor-green", 64, 64)
    pr = make_problem(params)
    f = start(pr)
    e, ts = [], []
    for k in range(12):
        f = advance(pr, f, 150)
        rho, u = physics.moments(D2Q9, f.double())
        e.append(float(torch.sum(rho * (u[0] ** 2 + u[1] ** 2))))
        ts.append((k + 1) * 150.0)
    slope = np.polyfit(np.asarray(ts), np.log(np.asarray(e)), 1)[0]
    nu_eff = -slope / (2.0 * 2.0 * (2.0 * np.pi / 64.0) ** 2)
    rel = nu_eff / params.nu() - 1.0
    require(abs(rel) < 0.005, f"Taylor-Green nu {nu_eff} ({rel})")
    print(f"box gate Taylor-Green 64^2 f32, 1800 steps: nu_eff {nu_eff:.6f}"
          f" against {params.nu():.6f} ({100 * rel:+.3f}%, gate 0.5%)")

    # Kolmogorov: the laminar fixed point, the spin-up from rest
    params = box_params("kolmogorov", 32, 32, kolmogorov_n=1,
                        inlet_velocity=0.01)
    pr = make_problem(params)
    u0, kappa = params.inlet_velocity, kolmogorov_kappa(params)
    y = np.arange(32, dtype=np.float64)[:, None]
    _, u = physics.moments(D2Q9, advance(pr, start(pr), 1000).double())
    u = u.cpu().numpy()
    err = float(np.max(np.abs(u[0] - u0 * np.cos(kappa * y))) / u0)
    trans = float(np.max(np.abs(u[1])) / u0)
    require(err < 0.015 and trans < 0.005,
            f"Kolmogorov fixed point: {err}, transverse {trans}")
    rest = (np.ones((32, 32)), np.zeros((2, 32, 32)))
    pr = dataclasses.replace(pr, init_fields=rest)
    f, t, spin = start(pr), 0, []
    for t_target in (200, 600):
        f = advance(pr, f, t_target - t)
        t = t_target
        _, u = physics.moments(D2Q9, f.double())
        a = 2.0 * float(np.mean(u[0].cpu().numpy() * np.cos(kappa * y)))
        a_exp = u0 * (1.0 - np.exp(-params.nu() * kappa * kappa * t))
        spin.append(a / a_exp - 1.0)
        require(abs(spin[-1]) < 0.02, f"Kolmogorov spin-up at {t}: {a}, "
                f"{a_exp}")
    print(f"box gate Kolmogorov 32^2 f32: the laminar profile after 1000 "
          f"steps within {100 * err:.3f}% of u0 (gate 1.5%), transverse "
          f"{100 * trans:.4f}% (gate 0.5%); spin-up from rest at t = 200, "
          f"600: {100 * spin[0]:+.3f}%, {100 * spin[1]:+.3f}% (gate 2%)")

    # the passive scalar
    def amp_phase(problem, s):
        row = step_thermal.temperature(problem, s.double()).mean(
            dim=0).cpu().numpy()
        co = np.fft.rfft(row)[1]
        return 2.0 * np.abs(co) / row.shape[0], np.angle(co)

    base = dict(nx=64, ny=32, tau=0.8, thermal_tau=0.8, inlet_velocity=0.0)
    params = box_params("passive-scalar", **base)
    pr = make_problem(params)
    s = start(pr)
    a0, p0 = amp_phase(pr, s)
    q = 2.0 * np.pi / 64
    a1, _ = amp_phase(pr, advance(pr, s, 800))
    diff = a1 / a0 / np.exp(-pr.thermal.alpha * q * q * 800) - 1.0
    require(abs(diff) < 1e-3, f"pure diffusion {diff}")
    u = np.zeros((2, 32, 64))
    u[0] = 0.02
    pr = dataclasses.replace(pr, init_fields=(np.ones((32, 64)), u))
    s = start(pr)
    a0, p0 = amp_phase(pr, s)
    a1, p1 = amp_phase(pr, advance(pr, s, 500))
    dphase = (p1 - p0 + np.pi) % (2.0 * np.pi) - np.pi
    damp = a1 / a0 / np.exp(-pr.thermal.alpha * q * q * 500) - 1.0
    require(abs(dphase + q * 0.02 * 500) < 2e-3 and abs(damp) < 5e-3,
            f"advection phase {dphase}, amplitude {damp}")

    def final_var(u0):
        p = make_problem(box_params("passive-scalar", 64, 64, tau=0.55,
                                    thermal_tau=0.55, inlet_velocity=u0))
        return float(step_thermal.scalar_variance(
            p, advance(p, start(p), 4000).double()))

    v_stir, v_still = final_var(0.08), final_var(0.0)
    require(v_stir < 0.5 * v_still, f"stirring {v_stir} against {v_still}")
    print(f"box gate passive scalar f32: pure diffusion 64x32, 800 steps, "
          f"{diff:+.3e} from exp(-alpha q^2 t) (gate 1e-3); uniform "
          f"advection 500 steps, phase {dphase:.6f} against "
          f"{-q * 0.02 * 500:.6f} (gate 2e-3), amplitude {damp:+.3e} (gate "
          f"5e-3); stirring 64^2, 4000 steps: variance {v_stir:.4e} against "
          f"{v_still:.4e} at rest (gate < 0.5x)")

    # the shear-layer preset under the regularized operator
    preset = PRESETS["shear-layer"]
    d = OUT_DIR / "shear_layer_preset"
    res, c, w = run_counted(preset.replace(output_dir=str(d)), dev)
    text = (d / "velocity_field.csv").read_bytes().lower()
    require(text.count(b"\n") == preset.nx * preset.ny + 1
            and b"nan" not in text and b"inf" not in text,
            "shear-layer preset: velocity_field.csv not finite")
    print(f"box gate shear-layer preset 128^2 (Re 30,000, regularized), "
          f"{preset.num_timesteps} steps: {c[4]} N=4 launches, finite "
          f"velocity field, {w:.2f} s wall")
    print(f"box gates: {time.perf_counter() - t0:.2f} s")


def box_builds():
    """(source, mode, variant) of the libraries phases 35-40 run: both
    D2Q9 sources in the box under every collision, with the force profile
    under BGK and MRT, and the box's ring builds with and without it."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.ops.step_cuda import FORCE, RINGS
    box = step_cuda.DOMAINS.index("box")
    d2 = ("step_d2q9.cu", "step_d2q9_blocked.cu")
    builds = [(src, mode, box) for mode in step_cuda.COLLISION_MODES
              for src in d2]
    builds += [(src, mode, box | FORCE) for mode in ("bgk", "mrt")
               for src in d2]
    builds += [(src, "bgk", box | v | RINGS) for v in (0, FORCE)
               for src in d2]
    return builds


def box_phases(dev, card: str) -> list[dict]:
    """Phases 35-40: the periodic boxes, Kolmogorov's force profile and the
    passive scalar. 35: one step of every box library against the plain
    step from the perturbed state (Taylor-Green under each collision,
    Kolmogorov under BGK and MRT; BGK from the initial and an advanced
    state too, and 280 steps), the cylinder's library > SEPARATION
    tolerances off, the force profile along y and x at F0 = 1e-2 against
    the box's library without it, N-step bitwise; 36: Taylor-Green and
    Kolmogorov through the Runner (525 N=4 + 140 1-step launches, the
    closed box's mass), Taylor-Green's N=3/N=2 run; 37: the meshes; 38:
    the passive scalar; 39: tpulbm's gates; 40: timing. Returns the
    kernels' JSON entries."""
    from tpulbm_torch.ops import step_cuda
    t_all = time.perf_counter()
    entries = []
    t0 = time.perf_counter()
    kol = box_params("kolmogorov")
    cells = [("taylor-green " + op, box_params("taylor-green", **kw),
              None, op == "bgk") for op, kw in CHANNEL_OPS.items()]
    cells += [("kolmogorov bgk", kol, None, True),
              ("kolmogorov x-force", kol, x_force_problem(kol), False),
              ("kolmogorov mrt", box_params("kolmogorov", collision="mrt"),
               None, False)]
    main = {}
    for label, params, problem, full in cells:
        cell = Cell(dev, label, params, problem)
        err = cell_parity(cell, full)
        if label in ("taylor-green bgk", "kolmogorov bgk"):
            main[label] = (cell, err)
        else:
            del cell
        torch.cuda.empty_cache()
    print(f"box parity (phase 35): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = {}
    for label, (cell, err) in main.items():
        run_dir = OUT_DIR / ("box_" + label.replace(" ", "_"))
        launches[label] = box_main_path(dev, cell, run_dir)
    cell = main["taylor-green bgk"][0]
    d23 = OUT_DIR / "box_taylor_green_f150"
    _, c23, _ = run_counted(cell.params.replace(
        num_timesteps=311, output_frequency=150, output_dir=str(d23)), dev)
    by = step_cuda.collide_stream_blocked.launches_by_library
    require(c23 == {**only(3, 100), 1: 1, 2: 5}
            and by == {cell.library: {2: 5, 3: 100, 4: 0}},
            f"box depths 3 and 2: {c23} {by}")
    launches["taylor-green bgk"].update({2: c23[2], 3: c23[3]})
    print(f"box depths 3 and 2 taylor-green: 311 steps every 150, launches "
          f"{c23[3]} N=3 + {c23[2]} N=2 + {c23[1]} 1-step of {cell.library}"
          f" ({time.perf_counter() - t0:.2f} s for phase 36)")
    t0 = time.perf_counter()
    ring_launches = {}
    for label, (cell, err) in main.items():
        ring_launches[label] = box_mesh(dev, cell.problem, cell.f0)
        torch.cuda.empty_cache()
    print(f"box meshes (phase 37): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    entries.append(scalar_phases(dev, card))
    print(f"box scalar (phase 38): {time.perf_counter() - t0:.2f} s")
    box_gates(dev)
    t0 = time.perf_counter()
    for label, (cell, err) in main.items():
        ms, b = cell_timing(cell, card, tuple(sorted(launches[label])))
        entries += cell_entries(cell, launches[label], err, ms, b)
        fp = perturbed(cell.problem, cell.f0)
        for depth in (1, 4):
            rerr, rms, rb = box_ring_timing(cell.problem, dev, card, depth,
                                            fp)
            entries.append({
                "name": f"d2q9_rings_tiled{'' if depth == 1 else '_n4'}"
                        f"[{cell.library}]",
                "route": "cuda",
                "source": (step_cuda.KERNEL_SOURCE if depth == 1
                           else step_cuda.BLOCKED_SOURCE),
                "replaces": step_cuda.rings_replaces("tiled", depth),
                "launches": ring_launches[label][depth],
                "max_abs_err": rerr, "ms": rms["kernel"],
                "plain_ms": rms["plain"], **rb})
        torch.cuda.empty_cache()
    print(f"box timing (phase 40): {time.perf_counter() - t0:.2f} s; box "
          f"phases {time.perf_counter() - t_all:.2f} s")
    return entries


# ---- phases 41-45: the Bouzidi curved wall, still and spinning, on the
# ---- cylinder, the sphere and meshes of shards

# bench.py's bouzidi3d row: the sphere at 256^3 with a fractional radius,
# centred in x and y (bench.py:104-114)
BZ_SPHERE = dict(cylinder_radius=0.23, cylinder_x=0.5, cylinder_y=0.5)
# the collisions of the Bouzidi cells, by mode, with the kernel ladder's
# flags (OPERATORS, OPERATORS_3D)
BZ_OPS = {"bgk": {}, "trt": OPERATORS["trt"], "mrt": OPERATORS["mrt"],
          "regularized": OPERATORS["regularized"], "kbc": OPERATORS["kbc"],
          "smagorinsky": OPERATORS["les"],
          "power_law": OPERATORS["power_law"]}
BZ_OPS_3D = {"bgk": {}, **{("smagorinsky" if k == "les" else k): v
                           for k, v in OPERATORS_3D.items()}}
# tpulbm's Magnus gate (tests/test_bouzidi.py:473-503): 200x50, tau 0.62,
# U 0.05, radius 0.08 at x 0.25, the surface speed equal to U, 4000 steps
MAGNUS = dict(nx=200, ny=50, tau=0.62, inlet_velocity=0.05,
              cylinder_radius=0.08, cylinder_x=0.25, precision="f32",
              obstacle_bc="bouzidi")


def bz_builds():
    """(source, mode, variant) of the Bouzidi libraries: both D2Q9 sources
    under every D2Q9 collision, both D3Q19 sources under every D3Q19
    collision, and both D2Q9 ring builds under BGK."""
    from tpulbm_torch.ops import step_cuda
    bz = step_cuda.BOUZIDI
    d2 = ("step_d2q9.cu", "step_d2q9_blocked.cu")
    d3 = ("step_d3q19.cu", "step_d3q19_blocked.cu")
    builds = [(src, mode, bz) for mode in step_cuda.COLLISION_MODES
              for src in d2]
    builds += [(src, mode, bz) for mode in step_cuda.COLLISION_MODES_3D
               for src in d3]
    builds += [(src, "bgk", bz | step_cuda.RINGS) for src in d2]
    return builds


def bz_params(three_d: bool, op: str = "bgk", spin: bool = False):
    """The Bouzidi cylinder at re200 (bench.py's bouzidi row) or the sphere
    at 256^3 (its bouzidi3d row) under collision `op`; `spin`: the
    cylinder spinning at a surface speed equal to the inlet speed."""
    if three_d:
        return obstacle_params(True, obstacle_bc="bouzidi", **BZ_SPHERE,
                               **BZ_OPS_3D[op])
    params = obstacle_params(False, obstacle_bc="bouzidi", **BZ_OPS[op])
    if spin:
        params = params.replace(cylinder_omega=params.inlet_velocity / float(
            params.get_cylinder_radius_cells()))
    return params


def bz_link_bytes(problem) -> float:
    """Bytes of the link table a step reads, averaged over the cells: the
    Q-1 q entries (and Q-1 wall scalars when the wall moves) of every cell
    with a cut link, float32."""
    from tpulbm_torch.ops import bouzidi
    table = bouzidi.link_tables(problem)
    q = problem.lattice.Q
    links = int(bouzidi.link_cells(table, q).sum())
    planes = (q - 1) * (2 if table.shape[0] == 2 * q else 1)
    return links * planes * 4 / float(np.prod(problem.spatial_shape))


def bz_entries(cell, launches: dict, err: float, ms: dict, b: dict) -> list:
    """cell_entries of a Bouzidi cell, with the Pallas functions tpulbm's
    Bouzidi dispatch runs: the N-step cascade at N = 2 too
    (make_local_step_pallas2 refuses it), the tiled 3-D kernel at depth 1
    (the full-plane one does not take the table)."""
    from tpulbm_torch.ops import step_cuda
    out = cell_entries(cell, launches, err, ms, b)
    for e in out:
        if "_n2[" in e["name"] and not cell.three_d:
            e["replaces"] = step_cuda.BLOCKED_REPLACES[3]
        if cell.three_d and e["source"] == step_cuda.SOURCE_3D:
            e["replaces"] = "tpulbm/ops/step_pallas3d.py:745 at n_sub=1"
    return out


class BzCell(Cell):
    """A Bouzidi cell: Cell, whose bound counts the link table's bytes."""

    def bound(self, steps_per_launch: int) -> dict:
        lat = (("d3q27" if self.problem.lattice.Q == 27 else "d3q19")
               if self.three_d else "d2q9")
        mode = self.consts.mode
        flops = STEP_FLOPS[lat if mode == "bgk" else f"{lat}_{mode}"]
        q = self.problem.lattice.Q
        return bound_of(q * 4 * 2 + 1 + bz_link_bytes(self.problem), flops,
                        int(np.prod(self.problem.spatial_shape)),
                        steps_per_launch)


def bz_mesh_phase(dev, f0, problem) -> dict:
    """Phase 43: the Bouzidi cylinder (re200, still) on meshes of shards on
    the one card. From the perturbed state: every shard's ring launch
    against its plain ring step, the gathered result bitwise against one
    device, on (2,1) at N=4 (rows), (1,2) and (2,2) at depth 1 (tiled: the
    depth tpulbm takes for it) and (4,1) in the overlap mode at N=4; on
    (2,1) the equilibrium rings and a table whose rings read -1 (the
    neighbours' links dropped) must miss the plain step by SEPARATION
    tolerances. Then 280 steps on each mesh and mode, counted and bitwise
    against one device, and the Runner on each mesh (2240 steps every 140):
    its forces.csv and velocity_field.csv byte for byte those of the
    one-device run, its launches depth 1 on (1,2) and (2,2). Returns the
    ring launches by (mode, depth)."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.parallel import sharded_step
    from tpulbm_torch.runner import Runner
    t0 = time.perf_counter()
    fp = perturbed(problem, f0)
    one = {1: step_cuda.make_local_step_cuda(problem, dev),
           4: step_cuda.make_local_step_cuda_blocked(problem, dev, 4)}
    errs = []
    for shape, depth, x_rings, ranged in (((2, 1), 4, False, False),
                                          ((1, 2), 1, True, False),
                                          ((2, 2), 1, True, False),
                                          ((4, 1), 4, False, True)):
        err, sep = ring_parity(problem, fp, shape, dev, depth, x_rings,
                               lambda f, d=depth: one[d](
                                   f, torch.empty_like(f)),
                               ranged=ranged, sep_check=shape == (2, 1))
        errs.append(err)
        print(f"bouzidi mesh parity {shape} N={depth}"
              f"{' overlap' if ranged else ''}: every shard within "
              f"{err:.3e} of its plain ring step, bitwise one device"
              f"{sep_text(sep)}")
    # the table's rings: -1 past the block, the link bits cleared there
    case = MeshCase(problem, (2, 1), dev, 4, False)
    blocks = case.split(fp)
    rings = case.rings(blocks)
    tol, sep = n_step_tol(4), 0.0
    for idx, shard in case.shards.items():
        d = shard.depth
        inner = torch.zeros_like(shard.mask, dtype=torch.bool)
        inner[d:-d, d:-d] = True
        links = torch.where(inner[None] | (torch.arange(
            shard.links.shape[0], device=dev) >= 9)[:, None, None],
            shard.links, -1.0).contiguous()
        mask = torch.where(inner, shard.mask,
                           shard.mask & step_cuda.SOLID_BIT).contiguous()
        bad = dataclasses.replace(shard, links=links, mask=mask)
        out = torch.empty_like(blocks[idx[0]][idx[1]])
        step_cuda.collide_stream_rings(blocks[idx[0]][idx[1]], out,
                                       rings[idx[0]][idx[1]], bad,
                                       case.consts, 4)
        want = case.plains[idx](blocks[idx[0]][idx[1]],
                                *rings[idx[0]][idx[1]])
        sep = max(sep, float(((out - want).abs() / (
            tol["atol"] + tol["rtol"] * want.abs())).max()))
    require(sep > SEPARATION, f"bouzidi (2,1) N=4: a table without its "
            f"rings only {sep:.1f}x the tolerance off")
    print(f"bouzidi mesh (2,1) N=4: the table's rings at -1 {sep:.0f}x the "
          "tolerance off the plain ring step")
    del case, blocks, rings
    launches = {}
    for shape, env, kind in (((2, 1), {}, "rows"), ((1, 2), {}, "tiled"),
                             ((2, 2), {}, "tiled"),
                             ((4, 1), {"TPULBM_HALO_OVERLAP": "1"},
                              "overlap")):
        mesh = card_mesh(shape, dev)

        def run_both(mesh=mesh):
            chunk = sharded_step.make_chunk_fn(problem, mesh, 280)
            want = step_cuda_chunk(problem, dev, 280)(fp.clone())
            blocks = sharded_step.split(mesh, fp)
            reset_counts()
            got = chunk(blocks)
            torch.cuda.synchronize()
            return chunk, got, want, ring_counts(), read_counts()

        chunk, got, want, counts, others = with_env(env, run_both)
        require(torch.equal(gather(got), want),
                f"bouzidi mesh {shape} {env}: 280 steps off one device")
        plan = with_env(env, lambda mesh=mesh: mesh_plan_launches(
            problem, mesh, [280]))
        require(counts == plan and others == only(1, 0)
                and chunk.mode == kind
                and (kind == "tiled") == (chunk.substeps == 1),
                f"bouzidi mesh {shape} {env}: {chunk.mode} N="
                f"{chunk.substeps} launches {counts}, not {kind} {plan}")
        launches[kind, chunk.substeps] = (launches.get(
            (kind, chunk.substeps), 0) + sum(counts.values()))
        print(f"bouzidi mesh {shape} {env or ''} 280 steps: {chunk.mode} at "
              f"N={chunk.substeps}, {sum(counts.values())} ring launches, "
              "bitwise one device")
        del got, want
    # the Runner on each mesh against the one-device run (phase 42's)
    d_one = OUT_DIR / "bouzidi_bgk"
    for shape, env in (((2, 1), {}), ((1, 2), {}), ((2, 2), {}),
                       ((4, 1), {"TPULBM_HALO_OVERLAP": "1"})):
        d = OUT_DIR / (f"bouzidi_mesh_{shape[0]}x{shape[1]}"
                       + ("_ov" if env else ""))
        pm = bz_params(False).replace(
            num_timesteps=2240, output_frequency=140, output_dir=str(d),
            mesh_shape=shape)

        def run(pm=pm, shape=shape):
            runner = Runner(pm, devices=[dev] * (shape[0] * shape[1]),
                            verbose=False)
            reset_counts()
            t1 = time.perf_counter()
            result = runner.run()
            return result, time.perf_counter() - t1, ring_counts()

        result, wall, counts = with_env(env, run)
        require(result.success, f"bouzidi mesh {shape} run failed")
        depths = sorted({dd for (_, dd, _) in counts})
        require(shape[1] == 1 or depths == [1],
                f"bouzidi mesh {shape}: depths {depths}, not 1")
        require(same_files(d, d_one, ("forces.csv", "velocity_field.csv")),
                f"bouzidi mesh {shape} {env}: artifacts differ from one "
                "device")
        print(f"bouzidi mesh Runner {shape} {env or ''}: 2240 steps every "
              f"140, ring launches at N={depths} {sum(counts.values())}, "
              f"forces.csv and velocity_field.csv byte-identical to one "
              f"device; {wall:.2f} s wall, runner {result.mlups:.1f} MLUPS")
    print(f"bouzidi mesh phases: {time.perf_counter() - t0:.2f} s")
    return {"launches": launches, "err": max(errs)}


def bz_ring_timing(problem, dev, card: str, f0) -> list[dict]:
    """Phase 45's ring part: one shard's ring launch of the Bouzidi builds,
    (2,1) at N=4 (rows, row 2) and (1,2) at depth 1 (tiled, row 5), ms per
    step, CUDA events, against its plain ring step."""
    from tpulbm_torch.ops import step_cuda
    out = []
    for shape, depth, x_rings in (((2, 1), 4, False), ((1, 2), 1, True)):
        case = MeshCase(problem, shape, dev, depth, x_rings)
        blocks = case.split(perturbed(problem, f0))
        rings = case.rings(blocks)
        b0 = blocks[0][0]
        plain = case.plains[0, 0]
        got = case.launch(b0, torch.empty_like(b0), rings[0][0], (0, 0))
        want = plain(b0, *rings[0][0])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())

        def kern(f, m, case=case, rings=rings):
            return kernel_chunk(lambda g, o: case.launch(
                g, o, rings[0][0], (0, 0)), f, m // depth)

        def pl(f, m, plain=plain, rings=rings):
            for _ in range(m // depth):
                f = plain(f, *rings[0][0])
            return f

        times = {"k": [], "p": []}
        for which in ("k", "p", "p", "k"):
            run, m = (kern, 2400) if which == "k" else (pl, 20 * depth)
            times[which].append(ms_per_step(run, b0, m, 8))
        ms, pms = min(times["k"]), min(times["p"])
        cells = int(np.prod(case.local))
        b = bound_of(9 * 4 * 2 + 1 + bz_link_bytes(problem), 115, cells,
                     depth)
        mode = "rows" if not x_rings else "tiled"
        print(f"bouzidi ring timing {shape} N={depth} ({mode}) shard (0,0) "
              f"on {card}: {ms:.5f} ms/step (plain {pms:.5f}), "
              f"{100 * b['bound_ms'] / ms:.1f}% of {b['bound_ms']:.5f}")
        out.append({"mode": mode, "depth": depth, "ms": ms, "plain_ms": pms,
                    "err": err, **b})
        del case, blocks, rings
    return out


def bz_magnus(dev) -> None:
    """Phase 44: tpulbm's Magnus gate through the kernels in f32 (4000
    steps, make_chunk_fn): the lift nonzero, flipping with the spin,
    antisymmetric within 20%, the drag symmetric within 10%."""
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import forces
    from tpulbm_torch.stepper import make_chunk_fn

    def run(omega):
        problem = make_problem(SimulationParams(**MAGNUS,
                                                cylinder_omega=omega))
        f = initial_state(problem, dev)
        f = make_chunk_fn(problem, dev, 4000)(f)
        force = forces.forces_fn(problem, dev)(f)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(f).all()), "Magnus run not finite")
        return forces.force_coefficients(problem,
                                         force.double().cpu().numpy())

    om = MAGNUS["inlet_velocity"] / (MAGNUS["cylinder_radius"]
                                     * MAGNUS["ny"])
    (cd_p, cl_p), (cd_m, cl_m) = run(+om), run(-om)
    ok = (abs(cl_p) > 0.1 and cl_p * cl_m < 0
          and abs(cl_p + cl_m) < 0.2 * abs(cl_p - cl_m)
          and abs(cd_p - cd_m) < 0.1 * (cd_p + cd_m))
    require(ok, f"Magnus gate: C_D {cd_p}, {cd_m}, C_L {cl_p}, {cl_m}")
    print(f"bouzidi gate Magnus 200x50 f32, 4000 steps through the kernels: "
          f"C_L {cl_p:+.4f} / {cl_m:+.4f} at omega +-{om:.6f}, C_D "
          f"{cd_p:.4f} / {cd_m:.4f}; tests/test_bouzidi.py's four bounds "
          "held")


def bouzidi_phases(dev, card: str) -> list[dict]:
    """Phases 41-45, the Bouzidi curved wall through its libraries (built in
    phase 2, or here at first use). 41: the cylinder at re200 under each
    D2Q9 collision, still (and under BGK spinning): parity from the
    perturbed state, where the library without the rewrite (the
    equilibrium obstacle's) must miss the plain step by SEPARATION
    tolerances, from the initial and an advanced state, N = 2, 3, 4
    bitwise, 280 steps; 42: its Runner (525 N=4 + 140 1-step launches; BGK
    also 311 steps every 150 for N=3 and N=2) and a 64x32 Runner, kernel
    against plain, still and spinning; 43: the meshes (bz_mesh_phase); 44:
    the sphere at 256^3 under each D3Q19 collision (BGK in full with its
    Runner, the others from the perturbed state with a Runner of
    CUT_3D_STEPS) and tpulbm's Magnus gate; 45: timing. Returns the
    kernels' JSON entries."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import bouzidi, step_cuda
    from tpulbm_torch.utils import cuda_build
    t_all = time.perf_counter()
    for (src, mode, variant) in bz_builds():
        lib = cuda_build.load(src, step_cuda.build_defines(mode, variant))
        print(f"build: {src} {step_cuda.build_defines(mode, variant)} in "
              f"{lib.build_seconds:.2f} s ({ptxas_summary(lib.log)})")
    smem3 = {n: step_cuda._blocked_library_3d("bgk", step_cuda.BOUZIDI)
             .tpulbm_d3q19_blocked_smem_bytes(n) for n in DEPTHS_3D}
    print(f"build: the Bouzidi N-step D3Q19 kernel's dynamic shared memory "
          f"per block {smem3} B")
    entries = []
    t0 = time.perf_counter()
    cells2 = [("bouzidi " + op, bz_params(False, op)) for op in BZ_OPS]
    cells2.insert(1, ("bouzidi spin bgk", bz_params(False, spin=True)))
    mesh = ring_t = None
    for label, params in cells2:
        cell = BzCell(dev, label, params)
        # BGK's from an advanced state too; every library 280 steps
        err = cell_parity(cell, True, advanced=label.endswith("bgk"))
        run_dir = OUT_DIR / label.replace(" ", "_")
        launches = cell_main_path(dev, cell, run_dir)
        depths = (1, 4)
        if label == "bouzidi bgk":
            _, c23, _ = run_counted(params.replace(
                num_timesteps=311, output_frequency=150,
                output_dir=str(OUT_DIR / "bouzidi_f150")), dev)
            by = step_cuda.collide_stream_blocked.launches_by_library
            require(c23 == {**only(3, 100), 1: 1, 2: 5}
                    and by == {cell.library: {2: 5, 3: 100, 4: 0}},
                    f"bouzidi depths 3 and 2: {c23} {by}")
            launches.update({2: c23[2], 3: c23[3]})
            depths = cell.depths
            print(f"bouzidi depths 3 and 2: 311 steps every 150, launches "
                  f"{c23[3]} N=3 + {c23[2]} N=2 + {c23[1]} 1-step of "
                  f"{cell.library}")
            for extra in ({}, {"cylinder_omega": 0.02}):
                e = tiny_runner_agreement(
                    dev, "_bz" + ("_spin" if extra else ""),
                    obstacle_bc="bouzidi", **extra)
                print(f"bouzidi tiny Runner {extra or 'still'}: kernel "
                      f"against plain, forces within {e:.3e}")
            mesh = bz_mesh_phase(dev, cell.f0, cell.problem)
            ring_t = bz_ring_timing(cell.problem, dev, card, cell.f0)
        ms, b = cell_timing(cell, card, depths)
        new = bz_entries(cell, launches, err, ms, b)
        if "spin" in label:
            # the same library, its wall moving: its own entries
            for e in new:
                e["name"] = e["name"].replace("[", "_spinning[", 1)
        entries += new
        del cell
        torch.cuda.empty_cache()
    print(f"bouzidi phases 41-43 (2-D): {time.perf_counter() - t0:.2f} s")
    lib = step_cuda.StepConstants.of(make_problem(bz_params(False))).library
    for r in ring_t:
        n = sum(v for (mode, d), v in mesh["launches"].items()
                if d == r["depth"])
        entries.append({
            "name": f"d2q9_rings_{r['mode']}"
                    + ("" if r["depth"] == 1 else f"_n{r['depth']}")
                    + f"[{lib}]",
            "route": "cuda",
            "source": (step_cuda.KERNEL_SOURCE if r["depth"] == 1
                       else step_cuda.BLOCKED_SOURCE),
            "replaces": step_cuda.rings_replaces(r["mode"], r["depth"]),
            "launches": n, "max_abs_err": max(r["err"], mesh["err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    # 3-D; the sphere's link table built once on the host, timed
    t0 = time.perf_counter()
    sphere = make_problem(bz_params(True))
    table = bouzidi.link_tables(sphere)
    links = bouzidi.link_cells(table, sphere.lattice.Q)
    print(f"bouzidi link table of the sphere at 256^3: {int(links.sum())} "
          f"cells with a cut link ({int((table >= 0).sum())} links), "
          f"{table.shape[0]} planes, {table.nbytes / 1e6:.1f} MB, built on "
          f"the host in {time.perf_counter() - t0:.2f} s")
    del table, links
    for op in BZ_OPS_3D:
        problem = sphere
        if op != "bgk":
            # the same geometry: its table, not a second bisection
            problem = make_problem(bz_params(True, op))
            object.__setattr__(problem, "_bouzidi_tables",
                               bouzidi.link_tables(sphere))
            # and its copy on the card (1.27 GB), not a second upload
            bouzidi.device_table(sphere, dev)
            object.__setattr__(problem, "_bouzidi_device_tables",
                               sphere._bouzidi_device_tables)
        cell = BzCell(dev, "bouzidi sphere " + op, bz_params(True, op),
                      problem=problem)
        full = op == "bgk"
        err = cell_parity(cell, full)
        run_dir = OUT_DIR / ("bouzidi_sphere_" + op)
        # every operator's Runner cut to CUT_3D_STEPS, BGK's too since the
        # 3-D mesh phases (51-55) joined the budget
        launches = cell_main_path(dev, cell, run_dir, steps=CUT_3D_STEPS)
        shutil.rmtree(run_dir)
        ms, b = cell_timing(cell, card)
        entries += bz_entries(cell, launches, err, ms, b)
        del cell
        torch.cuda.empty_cache()
    print(f"bouzidi phase 44 (3-D): {time.perf_counter() - t0:.2f} s")
    bz_magnus(dev)
    print(f"bouzidi phases 41-45: {time.perf_counter() - t_all:.2f} s")
    return entries


# ---- phases 46-50: the 3-D boxes, 3-D Kolmogorov forcing and D3Q27

# bench.py's --periodic --nz row: the 3-D Taylor-Green box at 256^3 (tau
# 0.8, u0 0.04; bench.py:87-101)
PERIODIC3D_N = 256
# the 3-D builds off the three cells' paths (the box's other collisions,
# D3Q27's others, its bounce-back sphere, duct and Taylor-Green box) are
# held at this edge: the parity checks, 280 steps and timing
PARITY_N_3D = 64
# the Kolmogorov Runner's statistics window (from the middle of its 2240
# steps: 8 samples) and its two probes
KOL3D_STATS_FROM = 1120
KOL3D_PROBES = ((0.5, 0.5, 0.25), (0.25, 0.75, 0.5))
# the kernel Runner's statistics against the plain path's after 2240
# steps: each sample's populations drift at most DRIFT_280_BOUND in 280
# steps, linearly at worst, so the means within 8 times it and the
# stresses (products of two velocities near u0 = 0.05) within 2 u0 times
# that
KOL3D_MEAN_TOL = 8 * DRIFT_280_BOUND
KOL3D_STRESS_TOL = 2 * 0.05 * KOL3D_MEAN_TOL
# tpulbm's 3-D gates (tests/test_periodic.py:220-270,
# tests/test_kolmogorov.py:288-310)
ZWAVE_GATE = 0.02


def weight_excess(lat) -> float:
    """What the lattice's float32 weights sum to, less 1: D2Q9 2^-27, D3Q19
    2^-26, D3Q27 2^-27 (a closed box's f32 mass grows by it over tau a
    step)."""
    return float(lat.w.astype(np.float32).astype(np.float64).sum() - 1.0)


def box3d_params(name: str, n: int = PERIODIC3D_N, **kw):
    """The 3-D boxes: Taylor-Green at bench.py's --periodic --nz row (256^3
    by default), Kolmogorov at the preset kolmogorov3d (128^3, n 2, u0
    0.05, Re 20), each at n^3 with SimulationParams `kw`, f32, no VTK."""
    from tpulbm_torch.config import PRESETS, SimulationParams
    if name == "kolmogorov":
        base = PRESETS["kolmogorov3d"].replace(nx=n, ny=n, nz=n,
                                               precision="f32",
                                               enable_vtk=False)
        return base.replace(**kw)
    return SimulationParams(problem="taylor-green", nx=n, ny=n, nz=n,
                            tau=0.8, inlet_velocity=0.04, periodic_x=True,
                            cylinder_radius=0.0, precision="f32",
                            enable_vtk=False, **kw)


def box3d_builds():
    """(source, mode, variant) of the libraries phases 46-50 run: both 3-D
    sources for the box with the z force under every D3Q19 collision, the
    D3Q27 box with the force, the D3Q27 sphere (each under every collision
    but MRT), the box without the force (BGK, both sets), the D3Q27
    bounce-back sphere and duct; the box's 1-step libraries without the
    force under each collision and the D3Q27 duct's without its source, for
    the separation checks."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.ops.step_cuda import BOUNCE_BACK, D3Q27, FORCE, SOURCE
    box = step_cuda.DOMAINS_3D.index("box")
    duct = step_cuda.DOMAINS_3D.index("duct")
    d3 = ("step_d3q19.cu", "step_d3q19_blocked.cu")
    modes = step_cuda.COLLISION_MODES_3D
    no_mrt = [m for m in modes if m != "mrt"]
    builds = [(src, mode, box | FORCE) for mode in modes for src in d3]
    builds += [(src, mode, box | FORCE | D3Q27) for mode in no_mrt
               for src in d3]
    builds += [(src, mode, D3Q27) for mode in no_mrt for src in d3]
    builds += [(src, "bgk", v) for v in (box, box | D3Q27,
                                         D3Q27 | BOUNCE_BACK,
                                         duct | SOURCE | D3Q27)
               for src in d3]
    builds += [(d3[0], mode, box) for mode in modes if mode != "bgk"]
    builds += [(d3[0], mode, box | D3Q27) for mode in no_mrt
               if mode != "bgk"]
    builds += [(d3[0], "bgk", duct | D3Q27)]
    return builds


def d3q19_separation(cell: Cell, f: torch.Tensor,
                     want: torch.Tensor) -> float:
    """D3Q27's corners on the card: the D3Q19 library of the cell's
    collision and rules, run on the first 19 planes of the D3Q27 state f,
    must miss the first 19 planes of the plain D3Q27 step `want` by more
    than SEPARATION tolerances."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda
    consts = step_cuda.StepConstants.of(make_problem(
        cell.params.replace(lattice3d="d3q19")))
    f19 = f[:19].contiguous()
    links = None
    if consts.variant & step_cuda.BOUZIDI:
        # D3Q19's link table: D3Q27's first 19 planes (and the first 19 of
        # its wall block), the same directions in the same order
        from tpulbm_torch.ops import bouzidi
        table = bouzidi.device_table(cell.problem, f.device)
        links = torch.cat([table[:19]] + ([table[27:46]]
                                          if table.shape[0] == 54 else []))
    got = cell.launch(f19, torch.empty_like(f19), cell.solid, consts,
                      None, links)
    torch.cuda.synchronize()
    return separation(f"{cell.label}, D3Q19's {consts.library}", got,
                      want[:19], cell.tol)


def mode_separation(cell: Cell) -> str:
    """A collision beyond BGK acts on the card: from the perturbed state the
    same domain's BGK library must miss the collision's plain step by more
    than SEPARATION tolerances (near rest every closure rounds to BGK)."""
    from tpulbm_torch.ops import step_cuda
    if cell.consts.mode == "bgk":
        return ""
    fp = perturbed(cell.problem, cell.f0)
    bgk = dataclasses.replace(cell.consts, mode="bgk",
                              modes=(0.0,) * len(cell.consts.modes))
    got = cell.launch(fp, torch.empty_like(fp), cell.solid, bgk)
    sep = separation(f"{cell.label}, {bgk.library}", got, cell.pstep(fp),
                     cell.tol)
    return (f"; {bgk.library} {sep:.0f}x the tolerance off the "
            f"{cell.consts.mode} plain step")


def box3d_cells():
    """(label, params, main) of phase 46's cells: the three cells of the
    slice's path at full width (main), then the other builds at
    PARITY_N_3D^3."""
    from tpulbm_torch.config import SimulationParams
    n = PARITY_N_3D
    cells = [("periodic3d-256 bgk", box3d_params("taylor-green"), True),
             ("kolmogorov3d-128 bgk", box3d_params("kolmogorov", 128), True),
             ("sphere-256-d3q27 bgk", obstacle_params(True,
                                                      lattice3d="d3q27"),
              True)]
    for op, kw in OPERATORS_3D.items():
        cells.append((f"kolmogorov3d-{n} {op}",
                      box3d_params("kolmogorov", n, **kw), False))
    for op, kw in {"bgk": {}, **OPERATORS_3D}.items():
        if op == "mrt":
            continue
        cells.append((f"kolmogorov3d-{n}-d3q27 {op}",
                      box3d_params("kolmogorov", n, lattice3d="d3q27", **kw),
                      False))
        if op != "bgk":
            cells.append((f"sphere-{n}-d3q27 {op}", SimulationParams(
                problem="cylinder3d", nx=n, ny=n, nz=n, inlet_velocity=0.05,
                precision="f32", enable_vtk=False, lattice3d="d3q27", **kw),
                False))
    cells += [
        (f"taylor-green3d-{n}-d3q27 bgk",
         box3d_params("taylor-green", n, lattice3d="d3q27"), False),
        (f"sphere-{n}-d3q27 bounce-back", SimulationParams(
            problem="cylinder3d", nx=n, ny=n, nz=n, inlet_velocity=0.05,
            precision="f32", enable_vtk=False, lattice3d="d3q27",
            obstacle_bc="bounce_back"), False),
        (f"duct-{n}-d3q27 bgk", duct_params(n, lattice3d="d3q27"), False)]
    return cells


def box3d_fields_mass(label: str, problem, run_dir: Path,
                      t: int = 2239) -> str:
    """The closed box's mass in the Runner's fields3d.npz (the state at
    step t, the last but one) against the initial state's, through
    box_mass_gate with the lattice's float32 weights' term."""
    with np.load(run_dir / "fields3d.npz") as fields:
        m = float(np.sum(fields["rho"], dtype=np.float64))
    f0 = problem.initial_state()
    m0 = float(np.sum(f0, dtype=np.float64))
    return box_mass_gate(label, m, m0, t, weight_excess(problem.lattice),
                         problem.params.tau)


def kolmogorov3d_main_path(dev, cell: Cell, run_dir: Path) -> dict:
    """Phase 47 on the Kolmogorov cell: the Runner at 128^3 for 2240 steps
    every 140 with statistics from KOL3D_STATS_FROM and two probes, counted
    (exactly LAUNCHES_3D[2240] of the cell's library and none of another
    kernel), then the same run on the plain path (backend "jax", the plain
    step on the card): stats_fields.npz and probes.csv against it."""
    from tpulbm_torch.ops import step_cuda
    params = cell.params.replace(
        num_timesteps=2240, output_frequency=140, output_dir=str(run_dir),
        stats_from=KOL3D_STATS_FROM, probe_points=KOL3D_PROBES)
    result, counts, wall = run_counted(params, dev)
    n3, lib = LAUNCHES_3D[2240], cell.library
    by_lib = (step_cuda.collide_stream_3d.launches_by_library,
              step_cuda.collide_stream_3d_blocked.launches_by_library)
    require(counts == {**only("3d3", n3[3]), "3d2": n3[2], "3d": n3[1]}
            and by_lib == ({lib: n3[1]}, {lib: {2: n3[2], 3: n3[3]}}),
            f"{cell.label}: launch counts {counts} {by_lib}")
    plain_dir = run_dir.parent / (run_dir.name + "_plain")
    t0 = time.perf_counter()
    from tpulbm_torch.runner import Runner
    require(Runner(params.replace(backend="jax", output_dir=str(plain_dir)),
                   device=dev, verbose=False).run().success,
            "the plain path's Kolmogorov run failed")
    plain_wall = time.perf_counter() - t0
    errs = {}
    with np.load(run_dir / "stats_fields.npz") as got, \
            np.load(plain_dir / "stats_fields.npz") as want:
        require(sorted(got.files) == sorted(want.files) and (
            int(got["n_samples"]), int(got["first_step"]),
            int(got["sample_interval"])) == (8, KOL3D_STATS_FROM, 140),
            f"stats_fields.npz {got.files} {int(got['n_samples'])}")
        for k in got.files:
            if got[k].ndim:
                require(bool(np.isfinite(got[k]).all()), f"{k} not finite")
                errs[k] = float(np.abs(got[k].astype(np.float64)
                                       - want[k]).max())
    worst_mean = max(v for k, v in errs.items() if k.startswith("mean"))
    worst_re = max(v for k, v in errs.items() if k.startswith("re_"))
    require(worst_mean < KOL3D_MEAN_TOL and worst_re < KOL3D_STRESS_TOL,
            f"kernel statistics off the plain path's: {errs}")
    probes = [np.loadtxt(d / "probes.csv", delimiter=",", skiprows=1)
              for d in (run_dir, plain_dir)]
    require(probes[0].shape == (16, 9) and bool(np.isfinite(probes[0]).all())
            and np.array_equal(probes[0][:, 0], probes[1][:, 0]),
            f"probes.csv {probes[0].shape}")
    perr = float(np.abs(probes[0][:, 1:] - probes[1][:, 1:]).max())
    require(perr < KOL3D_MEAN_TOL, f"probes off the plain path's by {perr}")
    with np.load(run_dir / "stats_fields.npz") as got:
        re_xz = float(np.abs(got["re_uxuz"]).max())
        mean_ux = float(np.abs(got["mean_ux"]).max())
    print(f"box3d main path {cell.label}: 2240 steps every 140, launches "
          f"{counts['3d3']} N=3 + {counts['3d2']} N=2 + {counts['3d']} "
          f"1-step of {lib} and 0 others, {result.host_fetches} host "
          f"fetches in the loop, {wall:.2f} s wall, runner "
          f"{result.mlups:.1f} MLUPS; stats_fields.npz 8 samples from "
          f"{KOL3D_STATS_FROM} (max |mean ux| {mean_ux:.6f}, max |<ux'uz'>| "
          f"{re_xz:.3e}) against the plain path's ({plain_wall:.2f} s): "
          f"means {worst_mean:.3e} (gate {KOL3D_MEAN_TOL:.0e}), stresses "
          f"{worst_re:.3e} (gate {KOL3D_STRESS_TOL:.0e}), probes {perr:.3e}; "
          + box3d_fields_mass("flow", cell.problem, run_dir))
    return {1: counts["3d"], 2: counts["3d2"], 3: counts["3d3"]}


def kolmogorov2d_mesh_stats(dev) -> None:
    """Phase 48: the 2-D Kolmogorov box at bench.py's row (2048x512) with
    statistics from step 1120 and two probes, 2240 steps every 140, on one
    device and on a 2x2 mesh of shards on the card: stats_fields.npz and
    probes.csv byte-identical (the shards' states are the one device's,
    and the sums cell-local)."""
    from tpulbm_torch.runner import Runner
    t0 = time.perf_counter()
    params = box_params("kolmogorov", num_timesteps=2240,
                        output_frequency=140, stats_from=1120,
                        probe_points=((0.5, 0.25), (0.125, 0.875)))
    one, mesh = OUT_DIR / "kolmogorov_stats", OUT_DIR / "kolmogorov_stats_2x2"
    run_counted(params.replace(output_dir=str(one)), dev)
    require(Runner(params.replace(output_dir=str(mesh), mesh_shape=(2, 2)),
                   device=dev, devices=[dev] * 4,
                   verbose=False).run().success, "the 2x2 run failed")
    require(same_files(one, mesh, ["probes.csv", "velocity_field.csv"])
            and same_npz(one / "stats_fields.npz", mesh / "stats_fields.npz"),
            "the 2x2 mesh's statistics differ from one device's")
    with np.load(one / "stats_fields.npz") as st:
        n = int(st["n_samples"])
        require(n == 8 and all(bool(np.isfinite(st[k]).all())
                               for k in st.files), f"{n} samples")
    print(f"kolmogorov 2048x512 statistics (8 samples from 1120) and probes "
          f"on a 2x2 mesh of shards on the card: stats_fields.npz, "
          f"probes.csv, velocity_field.csv byte-identical to one device "
          f"({time.perf_counter() - t0:.2f} s for phase 48)")


def box3d_gates(dev) -> None:
    """Phase 49: tpulbm's 3-D physics gates through the kernels in f32: the
    z shear wave's decay within 2% of exp(-nu k^2 t) at nz 32 (1200
    steps) and second-order between nz 16 and 32 (tests/test_periodic.py:
    220-250, 8x8 columns, tau 0.8, amplitude 0.01); the 3-D Taylor-Green
    vortex's energy falling over 4 x 40 steps and its mass within the
    float32 weights' term (:253-270, 32x16x16); 3-D Kolmogorov's spin-up
    from rest within 2% of the linear solution after 400 steps
    (tests/test_kolmogorov.py:288-310, 16x8x32, n 1, u0 0.01)."""
    from tpulbm_torch import physics
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.models.periodic2d import kolmogorov3d_kappa
    from tpulbm_torch.stepper import make_chunk_fn

    t0 = time.perf_counter()

    def start(problem):
        return initial_state(problem, dev)

    def advance(problem, f, steps):
        out = make_chunk_fn(problem, dev, steps)(f)
        torch.cuda.synchronize()
        require(bool(physics.is_stable(out)),
                f"gate {problem.params.problem} unstable")
        return out

    def zwave_err(nz, steps):
        params = box3d_params("taylor-green", 8).replace(nz=nz)
        pr = make_problem(params)
        z = np.arange(nz)[:, None, None] * (2.0 * np.pi / nz)
        ux = 0.01 * np.sin(z) * np.ones((nz, 8, 8))
        pr = dataclasses.replace(pr, init_fields=(
            np.ones((nz, 8, 8)), np.stack([ux, 0 * ux, 0 * ux])))
        f = advance(pr, start(pr), steps)
        _, u = physics.moments(pr.lattice, f.double())
        amp = float(u[0].abs().max())
        want = 0.01 * np.exp(-params.nu() * (2.0 * np.pi / nz) ** 2 * steps)
        return abs(amp / want - 1.0)

    e16, e32 = zwave_err(16, 300), zwave_err(32, 1200)
    require(e32 < ZWAVE_GATE and 3.0 < e16 / e32 < 5.5,
            f"z shear wave: {e16}, {e32}")
    pr = make_problem(box3d_params("taylor-green", 16).replace(nx=32))
    f = start(pr)
    m0 = float(torch.sum(f, dtype=torch.float64))

    def energy(f):
        rho, u = physics.moments(pr.lattice, f.double())
        return float(torch.sum(rho * (u * u).sum(0)))

    e = [energy(f)]
    for _ in range(4):
        f = advance(pr, f, 40)
        e.append(energy(f))
    require(all(b < a for a, b in zip(e, e[1:])), f"TG energy {e}")
    mass = box_mass_gate("taylor-green3d", float(torch.sum(
        f, dtype=torch.float64)), m0, 160, weight_excess(pr.lattice),
        pr.params.tau)
    params = box3d_params("kolmogorov", 8).replace(
        nx=16, nz=32, kolmogorov_n=1, inlet_velocity=0.01, tau=0.8)
    pr = make_problem(params)
    rest = (np.ones((32, 8, 16)), np.zeros((3, 32, 8, 16)))
    pr = dataclasses.replace(pr, init_fields=rest)
    _, u = physics.moments(pr.lattice, advance(pr, start(pr), 400).double())
    kappa = kolmogorov3d_kappa(params)
    z = np.arange(32, dtype=np.float64)[:, None, None]
    a = 2.0 * float(np.mean(u[0].cpu().numpy() * np.cos(kappa * z)))
    a_exp = 0.01 * (1.0 - np.exp(-params.nu() * kappa * kappa * 400))
    require(abs(a / a_exp - 1.0) < 0.02, f"3-D spin-up {a}, {a_exp}")
    print(f"box3d gates f32: z shear wave decay off exp(-nu k^2 t) by "
          f"{e16:.3e} (nz 16, 300 steps), {e32:.3e} (nz 32, 1200 steps; "
          f"gate {ZWAVE_GATE}), ratio {e16 / e32:.2f} (gate 3-5.5, second "
          f"order); Taylor-Green 32x16x16 energy {e[0]:.6e} -> "
          f"{e[-1]:.6e}, falling at every 40 steps, {mass}; Kolmogorov "
          f"16x8x32 spin-up from rest after 400 steps "
          f"{100 * (a / a_exp - 1.0):+.3f}% of the linear solution (gate "
          f"2%) ({time.perf_counter() - t0:.2f} s)")


def box3d_phases(dev, card: str) -> list[dict]:
    """Phases 46-50: the fully periodic 3-D boxes, 3-D Kolmogorov's force
    along z and the D3Q27 velocity set through the two 3-D kernels
    (box3d_builds). 46: every build one step against the plain step from
    the initial and the perturbed state (and the three cells of the
    slice's path from an advanced state too, at full width), the other
    domain's, the D3Q19 set's, the forceless and the BGK library > 
    SEPARATION tolerances off, N-step bitwise against N 1-step launches,
    280 steps; 47: the three cells through the Runner (periodic3d-256,
    kolmogorov3d-128 with statistics and probes against the plain path's,
    sphere-256-d3q27), exactly 735 N=3, 17 N=2, 1 1-step launches each;
    48: the 2-D Kolmogorov statistics on a 2x2 mesh; 49: tpulbm's 3-D
    gates; 50: timing. Returns the kernels' JSON entries."""
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    main, others = {}, []
    for label, params, full in box3d_cells():
        cell = Cell(dev, label, params)
        # every drift at PARITY_N_3D^3: the full-width cells' plain 280
        # steps at DRIFT_N_3D^3 cut to make room for phases 61-66
        err = cell_parity(cell, True, advanced=full, drift_n=PARITY_N_3D)
        extra = mode_separation(cell)
        if extra:
            print(f"box3d separation {label}{extra}")
        if full:
            main[label] = (cell, err)
        else:
            others.append((cell, err))
        torch.cuda.empty_cache()
    print(f"box3d parity (phase 46): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = {}
    for label, (cell, err) in main.items():
        run_dir = OUT_DIR / ("box3d_" + label.split()[0])
        if label.startswith("kolmogorov"):
            launches[label] = kolmogorov3d_main_path(dev, cell, run_dir)
        else:
            # cut to CUT_3D_STEPS since the 3-D mesh phases (51-55) joined
            # the budget
            launches[label] = cell_main_path(dev, cell, run_dir,
                                             steps=CUT_3D_STEPS)
            if cell.problem.solid is None:
                print(f"box3d mass {label} at t = {CUT_3D_STEPS - 1}: "
                      + box3d_fields_mass("flow", cell.problem, run_dir,
                                          CUT_3D_STEPS - 1))
    print(f"box3d main paths (phase 47): {time.perf_counter() - t0:.2f} s")
    kolmogorov2d_mesh_stats(dev)
    box3d_gates(dev)
    t0 = time.perf_counter()
    entries = []
    for cell, err in [*main.values(), *others]:
        depths = (1, *DEPTHS_3D)
        ms, b = cell_timing(cell, card, depths)
        runs = launches.get(cell.label, dict.fromkeys(depths, 0))
        entries += cell_entries(cell, runs, err, ms, b)
        del cell
        torch.cuda.empty_cache()
    main.clear()
    others.clear()
    print(f"box3d timing (phase 50): {time.perf_counter() - t0:.2f} s; "
          f"box3d phases {time.perf_counter() - t_all:.2f} s")
    return entries


# ---- phases 51-55: the 3-D problems on a mesh of shards (the ring builds
# of both D3Q19 kernels)

# the meshes of phase 51 and tpulbm's 4x2 (its dryrun_multichip's
# sphere-3d-tiled family); the main path's mesh: sphere-256 (bench.py's
# d3q19 row, BASELINE config 5) on 2x2, four 256x128x128 shards on the card
MESH3D_SHAPES = ((2, 2), (4, 1), (1, 4))
MESH3D_N = 64
# every 3-D collision but BGK, each passing one parity case on (2,2)
MESH3D_OTHER_OPS = ("mrt", "regularized", "les", "power_law")


def mesh3d_cases():
    """(label, params, x-cut depths) of phase 51 at 64^3: the sphere, the
    bounce-back sphere under TRT, the Bouzidi sphere (depth 1 on x-cut
    meshes, as tpulbm), the duct, the box, the box with the z force, D3Q27
    on the sphere and the box, and one other collision a domain."""
    n = MESH3D_N
    sphere = obstacle_params(True).replace(nx=n, ny=n, nz=n)
    bz = bz_params(True).replace(nx=n, ny=n, nz=n)
    return [
        ("sphere", sphere, (1, 2, 3)),
        ("sphere bounce-back trt", sphere.replace(
            obstacle_bc="bounce_back", collision="trt"), (1, 2, 3)),
        ("sphere bouzidi", bz, (1,)),
        ("sphere trt", sphere.replace(collision="trt"), (1, 2, 3)),
        ("duct", duct_params(n), (1, 2, 3)),
        ("duct mrt", duct_params(n, collision="mrt"), (1, 2, 3)),
        ("box", box3d_params("taylor-green", n), (1, 2, 3)),
        ("box z force", box3d_params("kolmogorov", n), (1, 2, 3)),
        ("box z force regularized", box3d_params(
            "kolmogorov", n, collision="regularized"), (1, 2, 3)),
        ("sphere d3q27", sphere.replace(lattice3d="d3q27"), (1, 2, 3)),
        ("box d3q27", box3d_params("taylor-green", n, lattice3d="d3q27"),
         (1, 2, 3)),
    ] + [(f"sphere {op}", sphere.replace(**OPERATORS_3D[op]), ())
         for op in MESH3D_OTHER_OPS]


def mesh3d_builds():
    """(source, mode, variant) of the ring libraries phases 51-55 run: both
    D3Q19 sources built with -DTPULBM_RINGS=1 for each library of
    mesh3d_cases() (the spinning sphere shares the Bouzidi one)."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda
    out = []
    for _, params, _ in mesh3d_cases():
        c = step_cuda.kernel_constants(make_problem(params), 19)
        for src in ("step_d3q19.cu", "step_d3q19_blocked.cu"):
            b = (src, c.mode, c.variant | step_cuda.RINGS)
            if b not in out:
                out.append(b)
    return out


def ring3d_counts() -> dict:
    """The 3-D ring wrapper's launches per (library, depth, shard)."""
    from tpulbm_torch.ops import step_cuda
    return step_cuda.launches_by_shard(step_cuda.collide_stream_rings_3d)


def spinning_sphere(problem):
    """The sphere spinning about z at a surface speed equal to the inlet
    speed: its Bouzidi rule's moving-wall scalars, built by hand (tpulbm
    spins only the 2-D cylinder)."""
    p = problem.params
    c = np.array([p.get_cylinder_x(), p.get_cylinder_y(), p.nz // 2],
                 np.float64)
    omega = p.inlet_velocity / float(p.get_cylinder_radius_cells())

    def uw(pts):
        d = pts - c
        return np.stack([-omega * d[..., 1], omega * d[..., 0],
                         np.zeros_like(d[..., 0])], axis=-1)

    return dataclasses.replace(problem, obstacle_velocity=uw)


def one_device_step(problem, dev, depth: int):
    """The one-device 3-D kernel's step at `depth` (1, 2 or 3)."""
    from tpulbm_torch.ops import step_cuda
    if depth == 1:
        return step_cuda.make_local_step_cuda_3d(problem, dev)
    return step_cuda.make_local_step_cuda_3d_blocked(problem, dev, depth)


def mesh3d_parity(dev) -> dict:
    """Phase 51: every new ring build at 64^3. Returns {label: max error}."""
    from tpulbm_torch.models import make_problem
    errs = {}
    for label, params, depths in mesh3d_cases():
        problem = make_problem(params)
        f0 = initial_state(problem, dev)
        fp = perturbed(problem, f0)
        one = {d: one_device_step(problem, dev, d) for d in (1, 2, 3)}
        def one_device(g, d):
            return one[d](g, torch.empty_like(g))

        if not depths:
            # the remaining collisions: one case on (2,2) at depth 3
            err, sep = ring_parity(problem, fp, (2, 2), dev, 3, True,
                                   lambda g: one_device(g, 3),
                                   sep_check=True)
            errs[label] = err
            print(f"mesh3d parity {label} (2, 2) N=3 from the perturbed state:"
                  f" every shard within {err:.3e} of its plain ring step, "
                  f"bitwise one device, equilibrium rings {sep:.0f}x off")
            continue
        err, seps = 0.0, []
        for shape in MESH3D_SHAPES:
            # Bouzidi: every depth on a mesh that keeps x whole, depth 1 on
            # one that cuts it (tpulbm's dispatch)
            # the case's depths on (2,2); elsewhere 1 and 3, each
            # source's build (the Bouzidi sphere at depth 1 where the mesh
            # cuts x, tpulbm's dispatch)
            here = ((1, 3) if shape[1] == 1 else depths if shape == (2, 2)
                    else tuple(d for d in (1, 3) if d in depths))
            for depth in here:
                case = MeshCase(problem, shape, dev, depth, shape[1] != 1)
                for name, f in (("initial", f0), ("perturbed", fp)):
                    e, sep = ring_parity(problem, f, shape, dev, depth,
                                         shape[1] != 1,
                                         lambda g, d=depth: one_device(g, d),
                                         sep_check=name == "perturbed",
                                         case=case)
                    err = max(err, e)
                    if sep is not None:
                        seps.append(sep)
        # N-step ring launches bitwise N 1-step ring launches on (2,2)
        d3 = max(d for d in depths) if depths else 1
        if d3 > 1:
            deep = MeshCase(problem, (2, 2), dev, d3, True)
            shallow = MeshCase(problem, (2, 2), dev, 1, True)
            got = gather(deep.step_all(deep.split(fp)))
            blocks = shallow.split(fp)
            for _ in range(d3):
                blocks = shallow.step_all(blocks)
            want = gather(blocks)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"{label}: an N={d3} ring launch "
                    f"{float((got - want).abs().max())} off {d3} 1-step ones")
            del deep, shallow, got, want, blocks
        errs[label] = err
        print(f"mesh3d parity {label} at {MESH3D_N}^3 on {MESH3D_SHAPES}, "
              f"depths {depths} on (2, 2) and 1, 3 on the others (the "
              f"Bouzidi sphere: 1 where x is cut), from the initial and "
              f"the perturbed state: every shard within {err:.3e} of its "
              f"plain ring step (the N-step tolerance), every mesh bitwise "
              f"one device; equilibrium rings {min(seps):.0f}x the tolerance"
              f" off at least; N-step ring launches bitwise N 1-step ones")
        del one, f0, fp
        torch.cuda.empty_cache()
    return errs


# one-device runs kept for a later phase: label -> (run directory, final
# state, runner MLUPS)
ONE_DEVICE_RUNS: dict = {}


class CapturingRunner:
    """A Runner that keeps its final state (the grid of blocks) for a
    bitwise comparison."""

    def __new__(cls, *args, **kw):
        from tpulbm_torch.runner import Runner

        class _Runner(Runner):
            def write_final_results(self, f, fields_prev=None):
                self.final_state = f
                return super().write_final_results(f, fields_prev)

        return _Runner(*args, **kw)


def mesh3d_runner_pair(dev, params, shape, label: str, files) -> dict:
    """The Runner on `shape` (every shard on the card) against the
    one-device Runner (ONE_DEVICE_RUNS[label] where an earlier phase ran
    it): counted, the gathered final state bitwise, `files` the same bytes
    (.npz files: their arrays). Returns the counts per (library, depth,
    shard)."""
    from tpulbm_torch.parallel import sharded_step
    d_mesh = OUT_DIR / f"mesh3d_{label}_{shape[0]}x{shape[1]}"
    if label in ONE_DEVICE_RUNS:
        d_one, ref, mlups1 = ONE_DEVICE_RUNS.pop(label)
    else:
        d_one = OUT_DIR / f"mesh3d_{label}_1x1"
        one = CapturingRunner(params.replace(output_dir=str(d_one)),
                              device=dev, verbose=False)
        r1 = one.run()
        require(r1.success, f"{label}: the one-device run failed")
        ref, mlups1 = one.final_state[0][0], r1.mlups
        del one
    runner = CapturingRunner(params.replace(mesh_shape=shape,
                                            output_dir=str(d_mesh)),
                             devices=[dev] * (shape[0] * shape[1]),
                             verbose=False)
    reset_counts()
    t0 = time.perf_counter()
    result = runner.run()
    wall = time.perf_counter() - t0
    counts, others = ring3d_counts(), read_counts()
    require(result.success, f"{label} {shape}: the run failed")
    require(others == only(1, 0) and not ring_counts(),
            f"{label}: other kernels launched {others}")
    whole = sharded_step.gather(runner.final_state)
    torch.cuda.synchronize()
    require(torch.equal(whole, ref), f"{label} {shape}: the final state "
            f"{float((whole - ref).abs().max())} off one device's")
    for name in files:
        same = (same_npz(d_mesh / name, d_one / name, skip=("params",)) if
                name.endswith(".npz") else same_files(d_mesh, d_one, [name]))
        require(same, f"{label} {shape}: {name} differs from one device's")
    print(f"mesh3d runner {label} on {shape}, {params.num_timesteps} steps "
          f"every {params.output_frequency}: ring launches per shard "
          + ", ".join(f"N={d} {idx}: {n}" for (_, d, idx), n in
                      sorted(counts.items()))
          + f", 0 of another kernel; final state bitwise one device's, "
          f"{', '.join(files)} the same bytes; {wall:.2f} s wall, runner "
          f"{result.mlups:.1f} MLUPS (one device {mlups1:.1f}), "
          f"{result.host_fetches} host fetches")
    del runner, whole, ref
    torch.cuda.empty_cache()
    return counts


def mesh3d_chunks(dev, problem, shapes, steps: int) -> None:
    """`steps`-step chunks on each mesh of `shapes`, bitwise one device."""
    from tpulbm_torch.parallel import sharded_step
    f0 = perturbed(problem, initial_state(problem, dev))
    want = step_cuda_chunk(problem, dev, steps)(f0.clone())
    for shape in shapes:
        mesh = card_mesh(shape, dev)
        chunk = sharded_step.make_chunk_fn(problem, mesh, steps)
        got = sharded_step.gather(chunk(sharded_step.split(mesh, f0)))
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{steps} steps on {shape}: "
                f"{float((got - want).abs().max())} off one device")
        print(f"mesh3d {problem.params.problem} {problem.spatial_shape} "
              f"{steps} steps on {shape} ({chunk.mode}, plan {chunk.plan}) "
              f"from the perturbed state: bitwise one device")
        del got
    del f0, want
    torch.cuda.empty_cache()


def bz3d_mesh_forces(dev, problem, shapes, steps: int) -> None:
    """Phase 53: the Bouzidi sphere's `steps` steps on each mesh bitwise
    one device, its force (the cut-link momentum exchange with a one-cell
    ring per shard) within FORCES_TOL of one device's."""
    from tpulbm_torch.parallel import sharded_step
    f0 = initial_state(problem, dev)
    want = step_cuda_chunk(problem, dev, steps)(f0.clone())
    one = sharded_step.Diagnostics(problem, card_mesh((1, 1), dev))
    force_one = one.force([[want]]).cpu().numpy()
    for shape in shapes:
        mesh = card_mesh(shape, dev)
        chunk = sharded_step.make_chunk_fn(problem, mesh, steps)
        reset_counts()
        blocks = chunk(sharded_step.split(mesh, f0))
        counts = ring3d_counts()
        got = sharded_step.gather(blocks)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"bouzidi {steps} steps on {shape}: "
                f"{float((got - want).abs().max())} off one device")
        force = sharded_step.Diagnostics(problem, mesh).force(
            blocks).cpu().numpy()
        np.testing.assert_allclose(force, force_one, **FORCES_TOL)
        spin = problem.obstacle_velocity is not None
        print(f"mesh3d bouzidi{' spinning' if spin else ''} sphere "
              f"{problem.spatial_shape} {steps} steps on {shape} "
              f"({chunk.mode}, plan {chunk.plan}, "
              f"{sum(counts.values())} ring launches): bitwise one device; "
              f"force {force.tolist()} against {force_one.tolist()} "
              f"(max diff {float(np.abs(force - force_one).max()):.3e}, "
              f"rtol 1e-4 / atol 5e-6)")
        del blocks, got
    del f0, want
    torch.cuda.empty_cache()


def mesh3d_timing(dev, card: str, problem, shape, depth: int,
                  launches: int) -> dict:
    """Phase 55 for one ring build: every shard's launch from the perturbed
    state against its plain ring step (the line's max_abs_err), then, in
    turns, the one-device kernel at the same depth, the four shards' ring
    launches summed and one shard's plain ring step, ms per step; the
    bound per shard: the kernel's bytes a cell plus the rings'."""
    from tpulbm_torch.ops import step_cuda
    f0 = initial_state(problem, dev)
    fp = perturbed(problem, f0)
    case = MeshCase(problem, shape, dev, depth, shape[1] != 1)
    pblocks = case.split(fp)
    prings = case.rings(pblocks)
    got = case.step_all(pblocks, prings)
    tol, err = n_step_tol(depth), 0.0
    for (iy, ix), plain in case.plains.items():
        want = plain(pblocks[iy][ix], *prings[iy][ix])
        torch.testing.assert_close(got[iy][ix], want, **tol)
        err = max(err, float((got[iy][ix] - want).abs().max()))
    del pblocks, prings, got, want
    blocks = case.split(f0)
    rings = case.rings(blocks)
    outs = [[torch.empty_like(b) for b in row] for row in blocks]
    one = one_device_step(problem, dev, depth)
    spare = torch.empty_like(f0)
    plain = case.plains[0, 0]

    def timed(fn, reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps / depth

    def all_shards():
        for iy, ix in case.mesh.shards():
            case.launch(blocks[iy][ix], outs[iy][ix], rings[iy][ix], (iy, ix))

    runs = {"one": (lambda: one(f0, spare), 60),
            "rings": (all_shards, 60),
            "shard": (lambda: case.launch(blocks[0][0], outs[0][0],
                                          rings[0][0], (0, 0)), 120),
            "plain": (lambda: plain(blocks[0][0], *rings[0][0]), 2)}
    times = {k: [] for k in runs}
    for which in list(runs) + list(runs)[::-1]:
        times[which].append(timed(*runs[which]))
    ms = {k: min(v) for k, v in times.items()}
    nzl, nyl, nxl = case.local
    q = problem.lattice.Q
    hx = depth if case.x_rings else 0
    cells = nzl * nyl * nxl
    step_bytes = q * 4 * 2 + (1 if problem.solid is not None else 0)
    ring_bytes = 2 * q * 4 * nzl * (depth * (nxl + 2 * hx) + hx * nyl)
    bnd = bound_of(step_bytes, STEP_FLOPS["d3q19"] * q // 19, cells, depth)
    bnd["bound_ms"] += 1e3 * ring_bytes / depth / HBM_BYTES_PER_S
    lib = case.consts.library
    print(f"timing mesh3d {lib} {problem.spatial_shape} on {shape} "
          f"({'x rings' if case.x_rings else 'ring rows'}) N={depth} on "
          f"{card}: the {case.mesh.size} shards' ring "
          f"launches {ms['rings']:.5f} ms/step summed against the one-device"
          f" kernel's {ms['one']:.5f} "
          f"({100 * (ms['rings'] / ms['one'] - 1):+.2f}%); one "
          f"{nzl}x{nyl}x{nxl} shard {ms['shard']:.5f} ms/step "
          f"({100 * bnd['bound_ms'] / ms['shard']:.1f}% of its "
          f"{bnd['bound_ms']:.5f} ms bound), its plain ring step "
          f"{ms['plain']:.5f}; every shard within {err:.3e} of its plain "
          f"ring step from the perturbed state")
    kind = "tiled" if case.x_rings else "rows"
    entry = {"name": f"d3q19_rings_{kind}" + (f"_n{depth}" if depth > 1
                                              else "") + f"[{lib}]",
             "route": "cuda",
             "source": (step_cuda.SOURCE_3D if depth == 1
                        else step_cuda.SOURCE_3D_BLOCKED),
             "replaces": step_cuda.REPLACES_3D_RINGS,
             "launches": launches, "max_abs_err": err, "ms": ms["shard"],
             "plain_ms": ms["plain"], **bnd}
    del case, blocks, rings, outs, spare, f0, fp
    torch.cuda.empty_cache()
    return entry, ms


def mesh3d_phases(dev, card: str) -> list[dict]:
    """Phases 51-55: the 3-D problems on a mesh of shards through the ring
    builds of both D3Q19 kernels (mesh3d_builds). Returns their kernels'
    JSON entries."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.utils import cuda_build
    from tpulbm_torch.ops import step_cuda

    t_all = time.perf_counter()
    for src, mode, variant in mesh3d_builds():
        lib = cuda_build.load(src, step_cuda.build_defines(mode, variant))
        print(f"build: {src} {step_cuda.build_defines(mode, variant)} (a 3-D "
              f"ring build) in {lib.build_seconds:.2f} s "
              f"({ptxas_summary(lib.log)})")

    # phase 51: parity of every new build at 64^3
    t0 = time.perf_counter()
    errs = mesh3d_parity(dev)
    print(f"mesh3d parity (phase 51): {time.perf_counter() - t0:.2f} s")

    # phase 52: the main path, sphere-256 on 2x2 through the Runner
    t0 = time.perf_counter()
    sphere = obstacle_params(True)
    main_params = sphere.replace(num_timesteps=2240, output_frequency=140)
    # held to phase 7's one-device run of the same parameters
    counts = mesh3d_runner_pair(dev, main_params, (2, 2), "sphere256",
                                ["forces.csv", "fields3d.npz"])
    lib = step_cuda.kernel_constants(make_problem(sphere), 19).library
    want = {(lib, d, idx): n for d, n in LAUNCHES_3D[2240].items()
            for idx in card_mesh((2, 2), dev).shards()}
    require(counts == want, f"sphere-256 2x2 launches {counts}, not {want}")
    main_launches = {d: sum(n for (_, dd, _), n in counts.items() if dd == d)
                     for d in (1, 2, 3)}
    mesh3d_chunks(dev, make_problem(sphere), ((4, 1), (1, 4), (4, 2)),
                  CUT_3D_STEPS)
    print(f"mesh3d main path (phase 52): {time.perf_counter() - t0:.2f} s")

    # phase 53: the Bouzidi sphere at 256^3, 280 steps
    t0 = time.perf_counter()
    bz = make_problem(bz_params(True))
    bz3d_mesh_forces(dev, bz, ((2, 1), (1, 2), (2, 2)), CUT_3D_STEPS)
    bz3d_mesh_forces(dev, spinning_sphere(bz), ((2, 2),), CUT_3D_STEPS)
    print(f"mesh3d bouzidi (phase 53): {time.perf_counter() - t0:.2f} s")

    # phase 54: the boxes and D3Q27 through the Runner
    t0 = time.perf_counter()
    cut = dict(num_timesteps=CUT_3D_STEPS, output_frequency=140)
    mesh3d_runner_pair(dev, box3d_params("taylor-green").replace(**cut),
                       (2, 2), "periodic3d256", ["fields3d.npz"])
    kol = box3d_params("kolmogorov", 128).replace(
        stats_from=140, probe_points=((0.25, 0.5, 0.5), (0.75, 0.25, 0.6)),
        **cut)
    mesh3d_runner_pair(dev, kol, (2, 2), "kolmogorov3d128",
                       ["fields3d.npz", "stats_fields.npz", "probes.csv"])
    mesh3d_runner_pair(dev, obstacle_params(True, lattice3d="d3q27").replace(
        nx=128, ny=128, nz=128, **cut), (2, 2), "sphere128d3q27",
        ["forces.csv", "fields3d.npz"])
    mesh3d_runner_pair(dev, duct_params(128).replace(**cut), (1, 2),
                       "duct128", ["fields3d.npz"])
    print(f"mesh3d boxes and D3Q27 (phase 54): "
          f"{time.perf_counter() - t0:.2f} s")

    # phase 55: timing in turns against the one-device kernels
    t0 = time.perf_counter()
    entries = []
    problem = make_problem(sphere)
    for depth in (1, 2, 3):
        entry, _ = mesh3d_timing(dev, card, problem, (2, 2), depth,
                                 main_launches[depth])
        entry["max_abs_err"] = max(entry["max_abs_err"], errs["sphere"])
        entries.append(entry)
    entry, _ = mesh3d_timing(dev, card, problem, (4, 1), 3, 0)
    entries.append(entry)
    for depth, shape in ((3, (2, 1)), (1, (2, 2))):
        entry, _ = mesh3d_timing(dev, card, bz, shape, depth, 0)
        entries.append(entry)
    print(f"mesh3d timing (phase 55): {time.perf_counter() - t0:.2f} s; "
          f"mesh3d phases 51-55 {time.perf_counter() - t_all:.2f} s")
    return entries


# ---- phases 56-60: the thermal problems and multiphase on a mesh -------

# a ring cell's bytes, read once a launch: the thermal state's 14 planes
# and multiphase's 9
COUPLED_RING_BYTES = {"thermal": 14 * 4, "multiphase": 9 * 4}
COUPLED_STEPS = 280
# calls a turn in phase 60's timing, and the cycles the card sleeps while
# the host enqueues them (about 0.1 s at the H100's 1.98 GHz boost clock,
# more than the host takes to issue 800 launches)
COUPLED_REPS = {"one": 200, "rings": 200, "shard": 400, "issued": 200,
                "plain": 20}
COUPLED_SLEEP_CYCLES = 200_000_000


def coupled_builds():
    """The ring builds of the thermal source (BGK and the Smagorinsky
    closure) and of the multiphase source: (source, mode, variant)."""
    from tpulbm_torch.ops import step_cuda
    return ([("step_thermal.cu", mode, step_cuda.RINGS)
             for mode in ("bgk", "smagorinsky")]
            + [("step_multiphase.cu", "bgk", step_cuda.RINGS)])


def coupled_counts() -> dict:
    """The thermal and multiphase ring wrappers' launches per (kernel,
    library, depth, shard)."""
    from tpulbm_torch.ops import (step_cuda, step_multiphase_cuda,
                                  step_thermal_cuda)
    out = {}
    for kind, wrapper in (
            ("thermal", step_thermal_cuda.collide_stream_thermal_rings),
            ("multiphase",
             step_multiphase_cuda.collide_stream_multiphase_rings)):
        for key, n in step_cuda.launches_by_shard(wrapper).items():
            out[(kind,) + key] = n
    return out


class CoupledCase:
    """A thermal or multiphase problem on a mesh of `shape` shards on the
    card: each shard's geometry, the ring wrapper and its constants, each
    shard's plain ring step and the one-device kernel step."""

    def __init__(self, problem, shape, dev):
        from tpulbm_torch.ops import (step_cuda, step_multiphase,
                                      step_multiphase_cuda, step_thermal,
                                      step_thermal_cuda)
        from tpulbm_torch.parallel import sharded_step
        self.problem = problem
        self.kind = "thermal" if problem.thermal is not None else "multiphase"
        thermal = self.kind == "thermal"
        self.depth = 1 if thermal else step_multiphase_cuda.DEPTH
        self.mesh = card_mesh(shape, dev)
        self.local = sharded_step.block_shape(problem, self.mesh)
        self.x_rings = shape[1] != 1
        if thermal:
            self.consts = step_thermal_cuda.ThermalConstants.of(problem)
            self.wrapper = step_thermal_cuda.collide_stream_thermal_rings
            self.one = step_thermal_cuda.make_local_step_thermal_cuda(
                problem, dev)
            make_plain = step_thermal.make_ring_step_thermal
        else:
            self.consts = step_multiphase_cuda.MultiphaseConstants.of(problem)
            self.wrapper = \
                step_multiphase_cuda.collide_stream_multiphase_rings
            self.one = step_multiphase_cuda.make_local_step_multiphase_cuda(
                problem, dev)
            make_plain = step_multiphase.make_ring_step_multiphase
        self.geo = {cell: step_cuda.Shard(
            index=cell, origin=sharded_step.origin(self.mesh, self.local,
                                                   *cell),
            local_shape=self.local, grid=tuple(problem.spatial_shape),
            depth=self.depth, x_rings=self.x_rings)
            for cell in self.mesh.shards()}
        self.plains = {cell: make_plain(problem, g.origin, self.local, dev)
                       for cell, g in self.geo.items()}

    def split(self, f):
        from tpulbm_torch.parallel import sharded_step
        return sharded_step.split(self.mesh, f)

    def rings(self, blocks):
        from tpulbm_torch.parallel import halo
        p = self.problem
        return halo.exchange(blocks, eq_ring=p.ghost_ring_values(),
                             depth=self.depth, periodic_x=p.periodic_x,
                             periodic_y=p.periodic_y, x_rings=self.x_rings)

    def eq_rings(self, rings):
        """Every ring replaced by the frozen ghost equilibrium."""
        eq = torch.as_tensor(self.problem.ghost_ring_values(),
                             dtype=torch.float32)
        return [[tuple(None if r is None else
                       eq.to(r.device).reshape(-1, 1, 1).expand(r.shape)
                       .contiguous() for r in rs) for rs in row]
                for row in rings]

    def launch(self, block, out, rings, cell):
        self.wrapper(block, out, rings, self.geo[cell], self.consts)

    def step_all(self, blocks, rings):
        outs = [[torch.empty_like(b) for b in row] for row in blocks]
        for iy, ix in self.mesh.shards():
            self.launch(blocks[iy][ix], outs[iy][ix], rings[iy][ix],
                        (iy, ix))
        return outs


def coupled_parity(dev, label: str, problem, shapes) -> float:
    """Phase 56 for one problem: from the perturbed state, on each mesh of
    `shapes`, every shard's ring launch within the one-step tolerance of
    its plain ring step, the mesh bitwise one device's kernel step, and
    the launches fed equilibrium rings SEPARATION tolerances off. Returns
    the largest error against the plain ring step."""
    from tpulbm_torch.parallel import sharded_step
    fp = perturbed(problem, initial_state(problem, dev))
    err = 0.0
    for shape in shapes:
        case = CoupledCase(problem, shape, dev)
        want = case.one(fp, torch.empty_like(fp))
        blocks = case.split(fp)
        rings = case.rings(blocks)
        outs = case.step_all(blocks, rings)
        got = sharded_step.gather(outs)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{label} on {shape}: "
                f"{float((got - want).abs().max())} off one device")
        eq_outs = case.step_all(blocks, case.eq_rings(rings))
        seps = []
        for iy, ix in case.mesh.shards():
            plain = case.plains[iy, ix](blocks[iy][ix], *rings[iy][ix])
            torch.testing.assert_close(outs[iy][ix], plain, **ONE_STEP_TOL)
            err = max(err, float((outs[iy][ix] - plain).abs().max()))
            seps.append(separation(f"{label} on {shape}, shard {(iy, ix)}",
                                   eq_outs[iy][ix], plain, ONE_STEP_TOL))
        print(f"coupled parity {label} {problem.spatial_shape} on {shape} "
              f"({'x rings' if case.x_rings else 'ring rows'}, rings "
              f"{case.depth} deep) from the perturbed state: bitwise one "
              f"device; each shard within {err:.3e} of its plain ring step "
              f"(rtol 5e-6, atol 1e-7); equilibrium rings "
              f"{min(seps):.0f}-{max(seps):.0f}x the tolerance off")
        del case, blocks, rings, outs, eq_outs, got, want
    del fp
    torch.cuda.empty_cache()
    return err


def coupled_chunks(dev, label: str, problem, shapes, steps: int) -> dict:
    """`steps` steps from the perturbed state on each mesh of `shapes`
    through sharded_step.make_chunk_fn, counted and bitwise the one-device
    kernel's; for multiphase also the gathered physical velocity
    (sharded_step.Diagnostics.fields, padded blocks) bitwise one
    device's. Returns the ring launches on each mesh, summed over its
    shards."""
    from tpulbm_torch.parallel import sharded_step
    f0 = perturbed(problem, initial_state(problem, dev))
    want = step_cuda_chunk(problem, dev, steps)(f0.clone())
    one_fields = sharded_step.Diagnostics(
        problem, card_mesh((1, 1), dev)).fields([[want]])
    counts = {}
    for shape in shapes:
        mesh = card_mesh(shape, dev)
        chunk = sharded_step.make_chunk_fn(problem, mesh, steps)
        reset_counts()
        blocks = chunk(sharded_step.split(mesh, f0))
        counts[shape] = sum(coupled_counts().values())
        require(counts[shape] == steps * mesh.size,
                f"{label} on {shape}: {counts[shape]} ring launches, not "
                f"{steps} a shard")
        got = sharded_step.gather(blocks)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{label} {steps} steps on {shape}: "
                f"{float((got - want).abs().max())} off one device")
        text = ""
        if problem.shan_chen:
            rho, u = sharded_step.Diagnostics(problem, mesh).fields(blocks)
            require(torch.equal(rho, one_fields[0])
                    and torch.equal(u, one_fields[1]),
                    f"{label} on {shape}: the physical velocity "
                    f"{float((u - one_fields[1]).abs().max())} off one "
                    "device's")
            text = "; the physical velocity bitwise one device's"
        print(f"coupled {label} {problem.spatial_shape} {steps} steps on "
              f"{shape} ({chunk.mode}) from the perturbed state: bitwise "
              f"one device{text}; {counts[shape]} ring launches")
        del blocks, got
    del f0, want, one_fields
    torch.cuda.empty_cache()
    return counts


def coupled_runner_pair(dev, params, shape, label: str, same, close):
    """The Runner on `shape` (every shard on the card) against the
    one-device Runner (ONE_DEVICE_RUNS[label] where an earlier phase ran
    it): exactly num_timesteps ring launches a shard and none of another
    kernel, the gathered final state bitwise, the files `same` the same
    bytes, the traces `close` within FORCES_TOL. Returns the counts per
    (kernel, library, depth, shard)."""
    from tpulbm_torch.parallel import sharded_step
    d_mesh = OUT_DIR / f"coupled_{label}_{shape[0]}x{shape[1]}"
    if label in ONE_DEVICE_RUNS:
        d_one, ref, mlups1 = ONE_DEVICE_RUNS.pop(label)
    else:
        d_one = OUT_DIR / f"coupled_{label}_1x1"
        one = CapturingRunner(params.replace(output_dir=str(d_one)),
                              device=dev, verbose=False)
        r1 = one.run()
        require(r1.success, f"{label}: the one-device run failed")
        ref, mlups1 = one.final_state[0][0], r1.mlups
        del one
    runner = CapturingRunner(params.replace(mesh_shape=shape,
                                            output_dir=str(d_mesh)),
                             devices=[dev] * (shape[0] * shape[1]),
                             verbose=False)
    reset_counts()
    t0 = time.perf_counter()
    result = runner.run()
    wall = time.perf_counter() - t0
    counts, others = coupled_counts(), read_counts()
    require(result.success, f"{label} {shape}: the run failed")
    require(others == only(1, 0) and not ring_counts()
            and not ring3d_counts(), f"{label}: other kernels launched "
            f"{others}")
    shards = card_mesh(shape, dev).shards()
    require(sorted(k[-1] for k in counts) == sorted(shards)
            and set(counts.values()) == {params.num_timesteps},
            f"{label} {shape}: ring launches {counts}, not "
            f"{params.num_timesteps} a shard")
    whole = sharded_step.gather(runner.final_state)
    torch.cuda.synchronize()
    require(torch.equal(whole, ref), f"{label} {shape}: the final state "
            f"{float((whole - ref).abs().max())} off one device's")
    require(same_files(d_mesh, d_one, same),
            f"{label} {shape}: {same} differ from one device's")
    diffs = []
    for name in close:
        a, b = (np.loadtxt(d / name, delimiter=",", skiprows=1, ndmin=2)
                for d in (d_mesh, d_one))
        require(a.shape == b.shape and np.array_equal(a[:, 0], b[:, 0]),
                f"{label}: {name} rows differ")
        np.testing.assert_allclose(a, b, **FORCES_TOL)
        diffs.append(f"{name} max diff {float(np.abs(a - b).max()):.3e}")
    print(f"coupled runner {label} {params.nx}x{params.ny} on {shape}, "
          f"{params.num_timesteps} steps every {params.output_frequency}: "
          f"{params.num_timesteps} ring launches a shard, 0 of another "
          f"kernel; final state bitwise one device's, {', '.join(same)} "
          f"the same bytes; {'; '.join(diffs) or 'no trace'} (rtol 1e-4, "
          f"atol 5e-6); {wall:.2f} s wall, runner {result.mlups:.1f} MLUPS "
          f"(one device {mlups1:.1f}), {result.host_fetches} host fetches")
    del runner, whole, ref
    torch.cuda.empty_cache()
    return counts


def device_ms(fn, reps: int) -> float:
    """The card's time per call of `fn`, ms: `reps` calls enqueued behind
    a torch.cuda._sleep of COUPLED_SLEEP_CYCLES, so the card runs them back
    to back however slowly the host issues them (a shard's launch lasts
    less than the host takes to issue one); raises if the host took longer
    to enqueue them than the card slept."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s.record()
    torch.cuda._sleep(COUPLED_SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    b.record()
    torch.cuda.synchronize()
    require(host_ms < s.elapsed_time(a), f"the host took {host_ms:.3f} ms "
            f"to enqueue {reps} calls, the card slept "
            f"{s.elapsed_time(a):.3f} ms")
    return a.elapsed_time(b) / reps


def host_paced_ms(fn, reps: int) -> float:
    """Time per call of `fn`, ms, as the host issues them (CUDA events
    around `reps` calls after a warm-up): the rate a Runner can step."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def coupled_timing(dev, card: str, problem, shape, launches: int,
                   err: float) -> dict:
    """Phase 60 for one ring build and mesh, in turns: the card's time
    (device_ms) of the one-device kernel, of the shards' ring launches
    summed and of one shard's launch; the shards' launches as the host
    issues them and one shard's plain ring step (host_paced_ms), ms per
    step; one shard's bound with its rings' bytes (each ring cell read
    once). Returns the kernels line's entry."""
    from tpulbm_torch.ops import step_multiphase_cuda, step_thermal_cuda
    case = CoupledCase(problem, shape, dev)
    f0 = initial_state(problem, dev)
    blocks = case.split(f0)
    rings = case.rings(blocks)
    outs = [[torch.empty_like(b) for b in row] for row in blocks]
    spare = torch.empty_like(f0)
    plain = case.plains[0, 0]

    def all_shards():
        for iy, ix in case.mesh.shards():
            case.launch(blocks[iy][ix], outs[iy][ix], rings[iy][ix], (iy, ix))

    runs = {"one": (device_ms, lambda: case.one(f0, spare)),
            "rings": (device_ms, all_shards),
            "shard": (device_ms, lambda: case.launch(
                blocks[0][0], outs[0][0], rings[0][0], (0, 0))),
            "issued": (host_paced_ms, all_shards),
            "plain": (host_paced_ms, lambda: plain(blocks[0][0],
                                                   *rings[0][0]))}
    times = {k: [] for k in runs}
    for which in list(runs) + list(runs)[::-1]:
        timer, fn = runs[which]
        times[which].append(timer(fn, COUPLED_REPS[which]))
    ms = {k: min(v) for k, v in times.items()}
    nyl, nxl = case.local
    hx = case.depth if case.x_rings else 0
    ring_bytes = COUPLED_RING_BYTES[case.kind] * (
        2 * case.depth * (nxl + 2 * hx) + 2 * hx * nyl)
    bnd = bound(case.kind, nyl * nxl)
    bnd["bound_ms"] += 1e3 * ring_bytes / HBM_BYTES_PER_S
    mode = getattr(case.consts, "mode", "bgk")
    print(f"timing coupled {case.kind}[{mode}] {problem.spatial_shape} on "
          f"{shape} ({'x rings' if case.x_rings else 'ring rows'}) on "
          f"{card}, the card's time: the {case.mesh.size} shards' ring "
          f"launches {ms['rings']:.5f} ms/step summed against the "
          f"one-device kernel's {ms['one']:.5f} "
          f"({100 * (ms['rings'] / ms['one'] - 1):+.2f}%; runs "
          f"{[round(v, 6) for v in times['rings']]} and "
          f"{[round(v, 6) for v in times['one']]}); one {nyl}x{nxl} shard "
          f"{ms['shard']:.5f} ms ({100 * bnd['bound_ms'] / ms['shard']:.1f}%"
          f" of its {bnd['bound_ms']:.5f} ms bound with {ring_bytes} ring "
          f"bytes); as the host issues them, the shards' launches "
          f"{ms['issued']:.5f} ms/step; one shard's plain ring step "
          f"{ms['plain']:.5f} ms")
    kind = "tiled" if case.x_rings else "rows"
    mod = step_thermal_cuda if case.kind == "thermal" else \
        step_multiphase_cuda
    entry = {"name": f"{case.kind}_rings_{kind}[{mode}]", "route": "cuda",
             "source": mod.SOURCE, "replaces": mod.RINGS_REPLACES,
             "launches": launches, "max_abs_err": err, "ms": ms["shard"],
             "plain_ms": ms["plain"], **bnd}
    del case, blocks, rings, outs, spare, f0
    torch.cuda.empty_cache()
    return entry


def box_ranged_timing(dev, card: str) -> None:
    """Row 4's box build (tpulbm's ranged 1-step kernel under a periodic
    y): the overlap mode's three ranged launches a shard of Taylor-Green
    2048x512 on (4,1), every shard held against its plain ring step from
    the perturbed state, then one shard's three launches and its plain
    ring step timed in turns, ms per step, beside their bound."""
    from tpulbm_torch.models import make_problem
    problem = make_problem(box_params("taylor-green"))
    case = MeshCase(problem, (4, 1), dev, 1, False)
    fp = perturbed(problem, initial_state(problem, dev))
    pblocks = case.split(fp)
    prings = case.rings(pblocks)
    got = case.step_all(pblocks, prings, ranged=True)
    err = 0.0
    for (iy, ix), plain in case.plains.items():
        want = plain(pblocks[iy][ix], *prings[iy][ix])
        torch.testing.assert_close(got[iy][ix], want, **ONE_STEP_TOL)
        err = max(err, float((got[iy][ix] - want).abs().max()))
    blocks = case.split(initial_state(problem, dev))
    b, r = blocks[0][0], case.rings(blocks)[0][0]
    nyl, nxl = case.local

    def three(g, o):
        case.launch(g, o, (None,) * 4, (0, 0), rows=(2, nyl - 2))
        case.launch(g, o, r, (0, 0), rows=(0, 2))
        return case.launch(g, o, r, (0, 0), rows=(nyl - 2, nyl))

    plain = case.plains[0, 0]
    out = torch.empty_like(b)
    runs_ = {"plain": (host_paced_ms, lambda: plain(b, *r), 4),
             "kernel": (device_ms, lambda: three(b, out), 200),
             "issued": (host_paced_ms, lambda: three(b, out), 200)}
    times = {k: [] for k in runs_}
    for which in list(runs_) + list(runs_)[::-1]:
        timer, fn, reps = runs_[which]
        times[which].append(timer(fn, reps))
    ms = {k: min(v) for k, v in times.items()}
    bnd = bound_of(9 * 4 * 2, STEP_FLOPS["d2q9"], nyl * nxl)
    bnd["bound_ms"] += 1e3 * RING_BYTES * 2 * nxl / HBM_BYTES_PER_S
    print(f"timing box ranged (row 4, Taylor-Green {problem.spatial_shape} "
          f"on (4, 1), a {nyl}x{nxl} shard's three launches) on {card}: "
          f"the card's time {ms['kernel']:.5f} ms/step "
          f"({100 * bnd['bound_ms'] / ms['kernel']:.1f}% of its "
          f"{bnd['bound_ms']:.5f} ms bound), as the host issues them "
          f"{ms['issued']:.5f}, plain ring step {ms['plain']:.5f} ms/step; "
          f"every shard within {err:.3e} of its plain ring step from the "
          f"perturbed state")
    del case, fp, pblocks, prings, got, blocks, b, r, out
    torch.cuda.empty_cache()


def coupled_mesh_phases(dev, card: str) -> list[dict]:
    """Phases 56-60: the thermal problems and Shan-Chen multiphase on a
    mesh of shards through the ring builds of the thermal and multiphase
    kernels (coupled_builds). Returns their kernels' JSON entries."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.utils import cuda_build

    t_all = time.perf_counter()
    for src, mode, variant in coupled_builds():
        lib = cuda_build.load(src, step_cuda.build_defines(mode, variant))
        print(f"build: {src} {step_cuda.build_defines(mode, variant)} (a "
              f"ring build) in {lib.build_seconds:.2f} s "
              f"({ptxas_summary(lib.log)})")
    rb = thermal_params("rayleigh-benard", THERMAL_NX, THERMAL_NY)
    les = rb.replace(smagorinsky=THERMAL_CS)
    cavity = thermal_params("heated-cavity", 96, 96)
    scalar = box_params("passive-scalar")
    drop = mp_params(MP_NX, MP_NY)
    band = mp_params(MP_NX, MP_NY, cylinder_radius=0.0)

    # phase 56: parity of every new build from the perturbed state
    t0 = time.perf_counter()
    errs = {"rb": coupled_parity(dev, "rb", make_problem(rb),
                                 ((2, 2), (4, 1), (1, 4))),
            "les": coupled_parity(dev, "rb-les", make_problem(les),
                                  ((2, 2),)),
            "mp": coupled_parity(dev, "mp-droplet", make_problem(drop),
                                 ((4, 1), (2, 2)))}
    errs["rb"] = max(errs["rb"], coupled_parity(
        dev, "heated-cavity", make_problem(cavity), ((2, 2),)),
        coupled_parity(dev, "passive-scalar", make_problem(scalar),
                       ((2, 2),)))
    print(f"coupled parity (phase 56): {time.perf_counter() - t0:.2f} s")

    # phase 57: the thermal main path, rb-2048x512 on 2x2 through the
    # Runner, held to phase 10's one-device run
    t0 = time.perf_counter()
    main = coupled_runner_pair(
        dev, rb.replace(num_timesteps=2240, output_frequency=140), (2, 2),
        "rb2048", ["temperature_field.csv", "velocity_field.csv"],
        ["nusselt.csv"])
    print(f"coupled thermal main path (phase 57): "
          f"{time.perf_counter() - t0:.2f} s")

    # phase 58: the smaller thermal meshes
    t0 = time.perf_counter()
    cut = dict(num_timesteps=COUPLED_STEPS, output_frequency=140)
    rows = coupled_chunks(dev, "rb", make_problem(rb), ((4, 1), (1, 4)),
                          COUPLED_STEPS)
    les_counts = coupled_chunks(dev, "rb-les", make_problem(les), ((2, 2),),
                                COUPLED_STEPS)
    coupled_chunks(dev, "heated-cavity", make_problem(cavity), ((2, 2),),
                   COUPLED_STEPS)
    coupled_runner_pair(dev, scalar.replace(**cut), (2, 2), "scalar2048",
                        ["temperature_field.csv", "velocity_field.csv"],
                        ["scalar_variance.csv"])
    print(f"coupled thermal meshes (phase 58): "
          f"{time.perf_counter() - t0:.2f} s")

    # phase 59: multiphase, the droplet on tpulbm's dryrun layout (4,1)
    # through the Runner against phase 14's one-device run; the band on 2x2
    t0 = time.perf_counter()
    mp_main = coupled_runner_pair(
        dev, drop.replace(num_timesteps=2240, output_frequency=140), (4, 1),
        "mp2048", ["velocity_field.csv"], [])
    band_counts = coupled_chunks(dev, "mp-band", make_problem(band),
                                 ((2, 2),), COUPLED_STEPS)
    print(f"coupled multiphase (phase 59): {time.perf_counter() - t0:.2f} s")

    # phase 60: timing in turns against the one-device kernels
    t0 = time.perf_counter()

    entries = [
        coupled_timing(dev, card, make_problem(rb), (2, 2),
                       sum(main.values()), errs["rb"]),
        coupled_timing(dev, card, make_problem(rb), (4, 1), rows[4, 1],
                       errs["rb"]),
        coupled_timing(dev, card, make_problem(les), (2, 2),
                       les_counts[2, 2], errs["les"]),
        coupled_timing(dev, card, make_problem(drop), (4, 1),
                       sum(mp_main.values()), errs["mp"]),
        coupled_timing(dev, card, make_problem(drop), (2, 2),
                       band_counts[2, 2], errs["mp"])]
    box_ranged_timing(dev, card)
    print(f"coupled timing (phase 60): {time.perf_counter() - t0:.2f} s; "
          f"coupled phases 56-60 {time.perf_counter() - t_all:.2f} s")
    return entries


# ---- phases 61-66: the Bouzidi remainder: the D3Q27 Bouzidi sphere and
# the solid-slab channel, through Bouzidi builds of both D3Q19 and both
# D2Q9 sources (remainder_builds)

# the D3Q27 Bouzidi sphere's collisions (tpulbm has no MRT on D3Q27)
BZ27_OPS = {op: kw for op, kw in BZ_OPS_3D.items() if op != "mrt"}
# the D3Q27 Bouzidi sphere's meshes and Runners (phases 61-62) at
# BZ27_MID_N^3, its other collisions and its spinning wall at
# BZ27_SMALL_N^3
BZ27_MID_N = 128
BZ27_SMALL_N = 64
# the slab: tpulbm's _channel_problem geometry (tests/test_bouzidi.py:
# 68-91) at 2048x512, tau 0.8, a body force for a peak speed SLAB_U_MAX
# between the walls at y = 2 - qb and ny - 3 + qt; its other builds at
# SLAB_SMALL
SLAB_NX, SLAB_NY = 2048, 512
SLAB_SMALL = dict(nx=256, ny=64)
SLAB_TAU = 0.8
SLAB_U_MAX = 0.05
# tpulbm's slab gates (tests/test_bouzidi.py:112-130, 462-470): the
# fractional walls at 24x8 (6000 steps, F 2e-6), Couette at 20x8 (8000
# steps, the top wall at U 0.05), held there at 1e-6 of U in f64
SLAB_GATE = dict(nx=8, ny=24, force=2e-6, steps=6000)
COUETTE_GATE = dict(nx=8, ny=20, u=0.05, steps=8000)
COUETTE_TOL = 1e-6


def remainder_builds():
    """(source, mode, variant) of the libraries phases 61-66 run: both D3Q19
    sources with -DTPULBM_Q=27 -DTPULBM_BOUZIDI=1 under each D3Q27
    collision and their BGK ring builds; both D2Q9 sources for the slab
    (-DTPULBM_DOMAIN=1 -DTPULBM_SLAB=1): Bouzidi with the source under
    every D2Q9 collision, under BGK also without it (the moving wall),
    bounce-back and the equilibrium pin with it, and the Bouzidi ring
    builds."""
    from tpulbm_torch.ops import step_cuda as sc
    d2 = ("step_d2q9.cu", "step_d2q9_blocked.cu")
    d3 = ("step_d3q19.cu", "step_d3q19_blocked.cu")
    bz27 = sc.BOUZIDI | sc.D3Q27
    slab = sc.DOMAINS.index("channel") | sc.SLAB
    builds = [(src, mode, bz27) for mode in sc.COLLISION_MODES_3D
              if mode != "mrt" for src in d3]
    builds += [(src, "bgk", bz27 | sc.RINGS) for src in d3]
    builds += [(src, mode, slab | sc.SOURCE | sc.BOUZIDI)
               for mode in sc.COLLISION_MODES for src in d2]
    builds += [(src, "bgk", slab | v) for v in (
        sc.BOUZIDI, sc.SOURCE | sc.BOUNCE_BACK, sc.SOURCE) for src in d2]
    builds += [(src, "bgk", slab | sc.SOURCE | sc.BOUZIDI | sc.RINGS)
               for src in d2]
    return builds


def bz27_params(n: int = SPHERE_N, op: str = "bgk"):
    """bench.py's bouzidi3d row (the sphere at radius 0.23) on D3Q27 at
    n^3 under collision `op`."""
    return bz_params(True, op).replace(lattice3d="d3q27", nx=n, ny=n, nz=n)


def slab_problem(nx: int = SLAB_NX, ny: int = SLAB_NY, qb: float = 0.25,
                 qt: float = 0.75, bc: str = "bouzidi", force=None,
                 moving: float = 0.0, **kw):
    """tpulbm's solid-slab channel (tests/test_bouzidi.py:68-91, 416-459)
    on the port, as its gates build it: periodic x, no y walls, solid rows
    0-1 and ny-2..ny-1, the walls at y = 2 - qb and ny - 3 + qt, under the
    obstacle rule `bc`. `force`: the body force along x (default: a peak
    speed of SLAB_U_MAX between the walls; 0 for none); `moving`: the top
    wall's speed (Couette); kw: SimulationParams fields (a collision). The
    collision's fields come from the channel's builder."""
    from tpulbm_torch.config import SimulationParams
    from tpulbm_torch.models import make_problem
    tau = kw.pop("tau", SLAB_TAU)
    y0, y1 = 2.0 - qb, (ny - 3.0) + qt
    if force is None:
        force = 8.0 * (tau - 0.5) / 3.0 * SLAB_U_MAX / (y1 - y0) ** 2
    params = SimulationParams(problem="poiseuille", nx=nx, ny=ny, tau=tau,
                              periodic_x=True, inlet_velocity=0.0,
                              precision="f32", enable_vtk=False,
                              obstacle_bc=bc, body_force=(force, 0.0), **kw)
    solid = np.zeros((ny, nx), bool)
    solid[:2] = True
    solid[-2:] = True

    def sdf(p):
        return np.minimum(p[..., 1] - y0, y1 - p[..., 1])

    def uw(p):
        return np.stack([np.where(p[..., 1] > 0.5 * ny, moving, 0.0),
                         np.zeros_like(p[..., 0])], axis=-1)

    return dataclasses.replace(
        make_problem(params), solid=solid, obstacle_sdf=sdf,
        obstacle_velocity=uw if moving else None, init_u=(0.0, 0.0),
        walls_y=False, periodic_x=True, obstacle_bc=bc,
        body_force=(force, 0.0) if force else ())


class SlabCell(BzCell):
    """A slab cell: BzCell on slab_problem(**slab_kw), its source check
    on the slab too."""

    def __init__(self, dev, label: str, **slab_kw):
        problem = slab_problem(**slab_kw)
        super().__init__(dev, label, problem.params, problem=problem,
                         remake=lambda body_force, **_: slab_problem(
                             **{**slab_kw, "force": body_force[0]}))

    def bound(self, steps_per_launch: int) -> dict:
        """The populations read and written once and the mask byte a cell,
        the link table's bytes under the Bouzidi rule; the collision's
        operations and one add a population for the source."""
        from tpulbm_torch.ops import step_cuda
        mode = self.consts.mode
        flops = STEP_FLOPS["d2q9" if mode == "bgk" else f"d2q9_{mode}"]
        bz = self.problem.obstacle_bc == "bouzidi"
        return bound_of(9 * 4 * 2 + 1 + (bz_link_bytes(self.problem)
                                         if bz else 0),
                        flops + (9 if self.consts.variant & step_cuda.SOURCE
                                 else 0),
                        int(np.prod(self.problem.spatial_shape)),
                        steps_per_launch)


def link_count(problem) -> tuple[int, int]:
    """(cells with a cut link, cut links) of the problem's link table;
    raises where there is none (the table would not be read)."""
    from tpulbm_torch.ops import bouzidi
    table = bouzidi.link_tables(problem)
    q = problem.lattice.Q
    cells = int(bouzidi.link_cells(table, q).sum())
    links = int((table[:q] >= 0).sum())
    require(cells > 0, f"{problem.params.problem}: no cell has a cut link")
    return cells, links


def staircase_miss(cell: Cell) -> float:
    """A Bouzidi build fed a table whose every cut link sits at q = 1/2
    (tpulbm's staircase) misses the plain step of the true table by more
    than SEPARATION tolerances: one launch of the 1-step library from the
    perturbed state. Returns by how many."""
    from tpulbm_torch.ops import bouzidi, step_cuda
    fp = perturbed(cell.problem, cell.f0)
    table = bouzidi.device_table(cell.problem, fp.device)
    q = cell.problem.lattice.Q
    stair = table.clone()
    stair[:q] = torch.where(table[:q] >= 0, 0.5, table[:q])
    mask = torch.as_tensor(step_cuda.kernel_mask(cell.problem),
                           device=fp.device)
    got = cell.launch(fp, torch.empty_like(fp), mask, cell.consts, None,
                      stair)
    sep = separation(f"{cell.label}, every cut link at q = 1/2", got,
                     cell.pstep(fp), cell.tol)
    print(f"staircase {cell.label} [{cell.library}]: the build fed every cut "
          f"link at q = 1/2 misses the plain step of the true table by "
          f"{sep:.0f}x the tolerance (gate > {SEPARATION}x)")
    del fp, stair, got
    torch.cuda.empty_cache()
    return sep


def counted_run(cell: Cell, steps: int = CUT_3D_STEPS) -> dict:
    """The Runner's chunks (140, then 139 and 1) of `steps` steps through
    the stepper, counted: exactly the one-device plan's launches of the
    cell's own library (2-D LAUNCHES_2D, 3-D LAUNCHES_3D), none of another
    kernel. Returns the launches by depth."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.stepper import make_chunk_fn
    chunks = [make_chunk_fn(cell.problem, cell.f0.device, n)
              for n in [140] * (steps // 140 - 1) + [139, 1]]
    f = cell.f0.clone()
    reset_counts()
    for chunk in chunks:
        f = chunk(f)
    torch.cuda.synchronize()
    counts = read_counts()
    require(bool(torch.isfinite(f).all()), f"{cell.label}: not finite")
    lib = cell.library
    if cell.three_d:
        n3 = LAUNCHES_3D[steps]
        want = {**only("3d3", n3[3]), "3d2": n3[2], "3d": n3[1]}
        ok = (step_cuda.collide_stream_3d.launches_by_library,
              step_cuda.collide_stream_3d_blocked.launches_by_library) == (
            {lib: n3[1]}, {lib: {2: n3[2], 3: n3[3]}})
        launches = {1: counts["3d"], 2: counts["3d2"], 3: counts["3d3"]}
    else:
        want = {**only(4, LAUNCHES_2D[steps]), 1: 140}
        ok = (step_cuda.collide_stream.launches_by_library,
              step_cuda.collide_stream_blocked.launches_by_library) == (
            {lib: 140}, {lib: {2: 0, 3: 0, 4: LAUNCHES_2D[steps]}})
        launches = {1: counts[1], 4: counts[4]}
    require(counts == want and ok, f"{cell.label}: launch counts {counts}, "
            f"not {want} all of {lib}")
    print(f"remainder run {cell.label}: {steps} steps in the Runner's "
          f"chunks, launches "
          + " + ".join(f"{n} {'1-step' if d == 1 else f'N={d}'}"
                       for d, n in sorted(launches.items(), reverse=True))
          + f" of {lib} and 0 others")
    return launches


def renamed(entries: list, tag: str) -> list:
    """Entries of a library run under another wall (spinning, moving):
    their names tagged, as phase 41's spinning cylinder's."""
    for e in entries:
        e["name"] = e["name"].replace("[", f"_{tag}[", 1)
    return entries


def forces_close(got: np.ndarray, want: np.ndarray) -> bool:
    """Two runs' forces.csv rows (fx, fy) within FORCES_TOL, its rtol taken
    of each row's largest component: the symmetric sphere's lift is
    rounding noise (1e-5 against a drag of 1e2 at 128^3), which an atol
    fixed for small obstacles cannot hold."""
    g, w = got[:, 1:3], want[:, 1:3]
    scale = np.abs(w).max(axis=1, keepdims=True)
    return bool((np.abs(g - w) <= FORCES_TOL["atol"]
                 + FORCES_TOL["rtol"] * scale).all())


def runner_forces(dev, label: str, params, backend: str = "pallas",
                  devices=None) -> np.ndarray:
    """The Runner's forces.csv rows for `params` through `backend` (on
    `devices`, one a shard of params.mesh_shape, or on dev), the run's
    directory removed after."""
    from tpulbm_torch.runner import Runner
    d = OUT_DIR / label
    p = params.replace(output_dir=str(d), enable_vtk=False, backend=backend)
    runner = (Runner(p, devices=devices, verbose=False) if devices
              else Runner(p, device=dev, verbose=False))
    require(runner.run().success, f"{label} run failed")
    rows = check_forces(d, list(range(0, p.num_timesteps,
                                      p.output_frequency)))
    shutil.rmtree(d)
    return rows


def bz27_timing(cell: Cell, card: str) -> tuple[dict, dict]:
    """Phase 66's D3Q27 part: cell_timing of the Bouzidi sphere with the
    same sphere's library without the rewrite (the equilibrium obstacle,
    PERF.md §6 rows 6-7) in the same turns, at each depth."""
    from tpulbm_torch.ops import step_cuda
    base = dataclasses.replace(
        cell.consts, variant=cell.consts.variant & ~step_cuda.BOUZIDI)
    others = {"eq1": (lambda f, o: step_cuda.collide_stream_3d(
        f, o, cell.solid, base), 1)}
    for d in DEPTHS_3D:
        others[f"eq{d}"] = (lambda f, o, d=d:
                            step_cuda.collide_stream_3d_blocked(
                                f, o, cell.solid, base, d), d)
    ms, b = cell_timing(cell, card, others=others)
    print(f"timing bouzidi d3q27 sphere {cell.problem.spatial_shape} on "
          f"{card}: " + "; ".join(
              f"{'1-step' if d == 1 else f'N={d}'} {ms[d]:.5f} ms/step "
              f"against {ms[f'eq{d}']:.5f} without the rewrite "
              f"({base.library}, {100 * (ms[d] / ms[f'eq{d}'] - 1):+.1f}%)"
              for d in (1, *DEPTHS_3D)))
    return ms, b


def bz27_phases(dev, card: str) -> list[dict]:
    """Phases 61-62: the D3Q27 Bouzidi sphere. 61: at 256^3
    (bouzidi3d-256-d3q27) the link table's cut links counted, one step
    against the plain step from the initial, an advanced and the
    perturbed state (the equilibrium obstacle's and D3Q19's libraries
    SEPARATION tolerances off), N = 2, 3 bitwise, 280 steps at
    PARITY_N_3D^3 within DRIFT_280_BOUND, the staircase table off, the Runner
    (CUT_3D_STEPS: 91 N=3 + 3 N=2 + 1 1-step launches), forces.csv of a
    BZ27_MID_N^3 Runner against the plain path's; the other collisions and
    the spinning sphere at BZ27_SMALL_N^3; 62: the meshes at
    BZ27_MID_N^3, (2,1) at N = 3 and 2, (2,2) at depth 1, spinning on
    (2,1), a (2,1) Runner's forces.csv against one device's; timing (66).
    Returns the kernels' JSON entries."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import bouzidi
    t_all = t0 = time.perf_counter()
    params = bz27_params()
    sphere = make_problem(params)
    cells, links = link_count(sphere)
    corners = int((bouzidi.link_tables(sphere)[19:27] >= 0).sum())
    print(f"bouzidi d3q27 link table of the sphere at "
          f"{sphere.spatial_shape}: {cells} cells "
          f"with a cut link ({links} links, {corners} along the corner "
          f"directions), built on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    cell = BzCell(dev, "bouzidi sphere d3q27 bgk", params, problem=sphere)
    # its drift at PARITY_N_3D^3, as phase 46's
    err = cell_parity(cell, True, drift_n=PARITY_N_3D)
    staircase_miss(cell)
    run_dir = OUT_DIR / "bouzidi_sphere_d3q27"
    launches = cell_main_path(dev, cell, run_dir, steps=CUT_3D_STEPS)
    shutil.rmtree(run_dir)
    mid = bz27_params(BZ27_MID_N).replace(num_timesteps=70,
                                          output_frequency=35)
    kernel = runner_forces(dev, "bz27_mid_kernel", mid)
    plain = runner_forces(dev, "bz27_mid_plain", mid, backend="jax")
    require(forces_close(kernel, plain), f"bouzidi d3q27 Runner: forces "
            f"{kernel[:, 1:3].tolist()} against {plain[:, 1:3].tolist()}")
    print(f"bouzidi d3q27 Runner {BZ27_MID_N}^3, 70 steps every 35: "
          f"forces.csv (fx, fy) {kernel[:, 1:3].tolist()} against the plain "
          f"path's {plain[:, 1:3].tolist()} (max diff "
          f"{float(np.abs(kernel[:, 1:3] - plain[:, 1:3]).max()):.3e}, rtol "
          "1e-4 of the row's largest / atol 5e-6)")
    ms, b = bz27_timing(cell, card)
    entries = bz_entries(cell, launches, err, ms, b)
    del cell
    torch.cuda.empty_cache()
    print(f"bouzidi d3q27 phase 61 ({SPHERE_N}^3): "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for op in [*[o for o in BZ27_OPS if o != "bgk"], "spinning"]:
        small = bz27_params(BZ27_SMALL_N, "bgk" if op == "spinning" else op)
        problem = make_problem(small)
        if op == "spinning":
            problem = spinning_sphere(problem)
        cell = BzCell(dev, f"bouzidi sphere d3q27 {op}", small,
                      problem=problem)
        link_count(problem)
        # the drift is the 256^3 cell's; here parity and N-step bits
        err = cell_parity(cell, True, advanced=False, drift=False)
        launches = counted_run(cell)
        ms, b = cell_timing(cell, card)
        new = bz_entries(cell, launches, err, ms, b)
        entries += renamed(new, "spinning") if op == "spinning" else new
        del cell
        torch.cuda.empty_cache()
    print(f"bouzidi d3q27 phase 61 ({BZ27_SMALL_N}^3): "
          f"{time.perf_counter() - t0:.2f} s")
    entries += bz27_mesh_phase(dev, card, kernel)
    print(f"bouzidi d3q27 phases 61-62: {time.perf_counter() - t_all:.2f} s")
    return entries


def bz27_mesh_phase(dev, card: str, one_rows: np.ndarray) -> list[dict]:
    """Phase 62: the D3Q27 Bouzidi sphere at BZ27_MID_N^3 on meshes of
    shards on the card. From the perturbed state every shard's ring
    launch against its plain ring step and the gathered result bitwise one
    device, equilibrium rings off, on (2,1) at N = 3 and 2 (ring rows, the
    link table's rings), (2,2) at depth 1 (x rings: tpulbm's depth for
    it), spinning on (2,1) at N = 3; 280-step chunks bitwise one device,
    each with its force; a (2,1) Runner's forces.csv against phase 61's
    one-device run (`one_rows`); the ring builds timed (phase 66).
    Returns their entries."""
    from tpulbm_torch.models import make_problem
    t0 = time.perf_counter()
    problem = make_problem(bz27_params(BZ27_MID_N))
    spin = spinning_sphere(problem)
    for prob, cases in ((problem, (((2, 1), 3, False), ((2, 1), 2, False),
                                   ((2, 2), 1, True))),
                        (spin, (((2, 1), 3, False),))):
        fp = perturbed(prob, initial_state(prob, dev))
        one = {d: one_device_step(prob, dev, d) for d in (1, 2, 3)}
        for shape, depth, x_rings in cases:
            err, sep = ring_parity(prob, fp, shape, dev, depth, x_rings,
                                   lambda g, d=depth: one[d](
                                       g, torch.empty_like(g)),
                                   sep_check=True)
            print(f"bouzidi d3q27 mesh parity "
                  f"{'spinning ' if prob is spin else ''}{shape} N={depth}:"
                  f" every shard within {err:.3e} of its plain ring step, "
                  f"bitwise one device{sep_text(sep)}")
        del fp, one
    bz3d_mesh_forces(dev, problem, ((2, 1), (2, 2)), CUT_3D_STEPS)
    bz3d_mesh_forces(dev, spin, ((2, 1),), CUT_3D_STEPS)
    mid = bz27_params(BZ27_MID_N).replace(num_timesteps=70,
                                          output_frequency=35,
                                          mesh_shape=(2, 1))
    reset_counts()
    mesh_rows = runner_forces(dev, "bz27_mesh_2x1", mid, devices=[dev] * 2)
    counts = ring3d_counts()
    require(forces_close(mesh_rows, one_rows), f"bouzidi d3q27 (2,1) "
            f"Runner: forces {mesh_rows[:, 1:3].tolist()} against "
            f"{one_rows[:, 1:3].tolist()}")
    print(f"bouzidi d3q27 mesh Runner (2,1) {BZ27_MID_N}^3, 70 steps every "
          f"35: {sum(counts.values())} ring launches, forces.csv within "
          f"{float(np.abs(mesh_rows[:, 1:3] - one_rows[:, 1:3]).max()):.3e}"
          " of one device's (rtol 1e-4 / atol 5e-6)")
    by_depth = {d: sum(n for (_, dd, _), n in counts.items() if dd == d)
                for d in (1, 2, 3)}
    entries = []
    for shape, depth in (((2, 1), 3), ((2, 2), 1)):
        entry, _ = mesh3d_timing(dev, card, problem, shape, depth,
                                 by_depth[depth])
        # the bound counts the shard's cut of the link table
        entry["bound_ms"] += (1e3 * bz_link_bytes(problem)
                              * np.prod(problem.spatial_shape)
                              / np.prod(shape) / depth / HBM_BYTES_PER_S)
        entries.append(entry)
    print(f"bouzidi d3q27 phase 62: {time.perf_counter() - t0:.2f} s")
    return entries


def slab_main_path(dev, cell: Cell) -> dict:
    """Phase 63's main path: the slab through the stepper for 2240 steps
    in the Runner's chunks (a super-chunk of 15 intervals of 140 with its
    diagnostics on the card, then 139 and 1), counted: exactly 525 N=4 +
    140 1-step launches of the cell's library and none of another kernel;
    finite forces and a stable run. Returns the launches by depth."""
    from tpulbm_torch import physics
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.stepper import make_chunk_fn, make_super_chunk_fn
    problem = cell.problem
    sup = make_super_chunk_fn(problem, dev, 140, 15)
    tail = [make_chunk_fn(problem, dev, n) for n in (139, 1)]
    f = initial_state(problem, dev)
    reset_counts()
    t0 = time.perf_counter()
    f, flat = sup(f)
    for chunk in tail:
        f = chunk(f)
    diags = sup.unpack(flat.cpu())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    lib = cell.library
    ok = (step_cuda.collide_stream.launches_by_library,
          step_cuda.collide_stream_blocked.launches_by_library) == (
        {lib: 140}, {lib: {2: 0, 3: 0, 4: 525}})
    require(counts == {**only(4, 525), 1: 140} and ok,
            f"slab main path: launch counts {counts}, not 525 N=4 + 140 "
            f"1-step of {lib}")
    forces = diags["forces"].double().numpy()
    require(bool(np.isfinite(forces).all()
                 and diags["stable"].bool().all()), "slab run unstable")
    _, u = physics.moments(problem.lattice, f)
    ux = u[0].mean(dim=1).double().cpu().numpy()
    cells = int(np.prod(problem.spatial_shape))
    print(f"slab main path {SLAB_NX}x{SLAB_NY} f32 (qb 0.25, qt 0.75, F "
          f"{problem.body_force[0]:.4e}): 2240 steps through the stepper, "
          f"launches 525 N=4 + 140 1-step of {lib} and 0 others, "
          f"{wall:.2f} s wall ({cells * 2240 / wall / 1e6:.1f} MLUPS), the "
          f"walls' force per interval finite ({forces[-1].tolist()} at "
          f"t = 1960), peak mean ux {ux.max():.4e} after 2240 steps from "
          "rest")
    return {1: counts[1], 4: counts[4]}


def slab_gates(dev, refs: dict | None = None) -> None:
    """Phase 64: tpulbm's slab gates through the kernels in f32
    (make_chunk_fn): the fractional walls (24x8, 6000 steps) at (0.25,
    0.75) and (0.9, 0.1): the profile's relative RMSE against the
    parabola < 0.01 and its roots within 0.05 of the true walls; the
    staircase contrast at (0.25, 0.75): bounce-back's root at the
    half-way plane within 0.1, Bouzidi's at the true wall within 0.05,
    bounce-back's RMSE over Bouzidi's (tpulbm: > 5 in f64; f32 rounding
    raises Bouzidi's RMSE from 0.002 to 0.0075, so in f32 the ratio is
    held within 10% of the f32 plain step's on the same run); Couette
    (20x8, 8000 steps, the top wall at U): the profile's error against
    the line, held by tpulbm at COUETTE_TOL of U in f64, in f32 (~4e-5 of
    U) within twice the f32 plain step's own error on the same run, the
    fitted walls within 1e-3 or twice the plain step's miss. `refs`: the
    plain references (gate_references, plain_profile) as futures, else
    computed here."""
    from tpulbm_torch import physics
    from tpulbm_torch.stepper import make_chunk_fn
    t0 = time.perf_counter()

    def profile(problem, steps):
        f = initial_state(problem, dev)
        f = make_chunk_fn(problem, dev, steps)(f)
        _, u = physics.moments(problem.lattice, f.double())
        return u[0][:, 0].cpu().numpy()

    def reference(kw, steps):
        fut = (refs or {}).get((tuple(sorted(kw.items())), steps))
        return fut.result() if fut is not None else plain_profile(kw, steps)

    g = SLAB_GATE
    yy = np.arange(g["ny"], dtype=np.float64)
    nu = (SLAB_TAU - 0.5) / 3.0
    fl = slice(2, g["ny"] - 2)

    def parabola(ux, y0, y1):
        ana = np.where((yy > y0) & (yy < y1),
                       g["force"] / (2 * nu) * (yy - y0) * (y1 - yy), 0.0)
        rel = float(np.sqrt(np.mean((ux[fl] - ana[fl]) ** 2)) / ana.max())
        return rel, np.sort(np.roots(np.polyfit(yy[4:-4], ux[4:-4], 2)))

    rmse = {}
    for qb, qt, bc in ((0.25, 0.75, "bouzidi"), (0.9, 0.1, "bouzidi"),
                       (0.25, 0.75, "bounce_back")):
        problem = slab_problem(g["nx"], g["ny"], qb, qt, bc, g["force"])
        y0, y1 = 2.0 - qb, (g["ny"] - 3.0) + qt
        rel, roots = parabola(profile(problem, g["steps"]), y0, y1)
        plain = ""
        if qb == 0.25:
            rmse[bc] = (rel, roots, parabola(reference(dict(
                nx=g["nx"], ny=g["ny"], bc=bc, force=g["force"]),
                g["steps"]), y0, y1)[0])
            plain = f" (the f32 plain step's {rmse[bc][2]:.3e})"
        if bc == "bouzidi":
            require(rel < 0.01 and abs(roots[0] - y0) < 0.05
                    and abs(roots[1] - y1) < 0.05,
                    f"fractional wall ({qb}, {qt}): RMSE {rel}, roots "
                    f"{roots} against {y0}, {y1}")
        print(f"slab gate {bc} ({qb}, {qt}) {g['ny']}x{g['nx']} f32, "
              f"{g['steps']} steps through the kernels: relative RMSE "
              f"{rel:.3e} against the parabola{plain}, roots "
              f"{roots.tolist()} against the walls {y0}, {y1}")
    (rel_b, roots_b, plain_b), (rel_s, roots_s, plain_s) = (
        rmse["bouzidi"], rmse["bounce_back"])
    ratio, ratio_p = rel_s / rel_b, plain_s / plain_b
    require(abs(ratio / ratio_p - 1.0) < 0.1 and abs(roots_s[0] - 1.5) < 0.1
            and abs(roots_b[0] - 1.75) < 0.05,
            f"staircase contrast: RMSE ratio {ratio} (the f32 plain step's "
            f"{ratio_p}), roots {roots_s[0]} and {roots_b[0]}")
    print(f"slab gate staircase: bounce-back's RMSE {ratio:.2f}x Bouzidi's "
          f"through the kernels, {ratio_p:.2f}x on the f32 plain step (gate "
          f"within 10% of it; tpulbm's > 5x is f64's), its wall at "
          f"{roots_s[0]:.4f} (the half-way plane 1.5), Bouzidi's at "
          f"{roots_b[0]:.4f} (1.75)")
    c = COUETTE_GATE
    yy_c = np.arange(c["ny"], dtype=np.float64)
    fl_c = slice(2, c["ny"] - 2)
    for qb, qt in ((0.25, 0.75), (0.9, 0.1)):
        problem = slab_problem(c["nx"], c["ny"], qb, qt, force=0.0,
                               moving=c["u"])
        y0, y1 = 2.0 - qb, (c["ny"] - 3.0) + qt

        def couette(ux):
            err = float(np.max(np.abs(ux[fl_c] - c["u"] * (yy_c[fl_c] - y0)
                                      / (y1 - y0))) / c["u"])
            co = np.polyfit(yy_c[fl_c], ux[fl_c], 1)
            miss = max(abs(-co[1] / co[0] - y0),
                       abs((c["u"] - co[1]) / co[0] - y1))
            return err, miss

        err_k, miss_k = couette(profile(problem, c["steps"]))
        err_p, miss_p = couette(reference(dict(
            nx=c["nx"], ny=c["ny"], qb=qb, qt=qt, force=0.0, moving=c["u"]),
            c["steps"]))
        require(err_k < max(COUETTE_TOL, 2 * err_p)
                and miss_k < max(1e-3, 2 * miss_p),
                f"Couette ({qb}, {qt}): kernel error {err_k} and wall miss "
                f"{miss_k}, the f32 plain step's {err_p} and {miss_p}")
        print(f"slab gate Couette ({qb}, {qt}) {c['ny']}x{c['nx']} f32, "
              f"{c['steps']} steps: the kernels' profile {err_k:.3e} of U "
              f"from the line (tpulbm's f64 bound {COUETTE_TOL}; the f32 "
              f"plain step's on the same run {err_p:.3e}, gate < "
              f"max({COUETTE_TOL}, 2x it)), the fitted walls within "
              f"{miss_k:.3e} (plain {miss_p:.3e}, gate < max(1e-3, 2x it))")
    print(f"slab gates (phase 64): {time.perf_counter() - t0:.2f} s")


def slab_mesh_phase(dev, card: str, cell: Cell) -> dict:
    """Phase 65: the slab (2048x512, Bouzidi) on meshes of shards on the
    card. From the perturbed state every shard's ring launch against its
    plain ring step and the gathered result bitwise one device,
    equilibrium rings off, on (2,1) at N=4 (rows), (1,2) and (2,2) at
    depth 1 (tiled: tpulbm's depth for Bouzidi); 280-step chunks on each,
    counted from the chunk plan and bitwise one device, the walls' force
    per shard against one device's. Returns the ring launches by depth
    and the largest ring error."""
    from tpulbm_torch.parallel import sharded_step
    t0 = time.perf_counter()
    problem = cell.problem
    fp = perturbed(problem, cell.f0)
    errs = []
    for shape, depth, x_rings in (((2, 1), 4, False), ((1, 2), 1, True),
                                  ((2, 2), 1, True)):
        err, sep = ring_parity(problem, fp, shape, dev, depth, x_rings,
                               lambda g, d=depth: cell.steps[d](
                                   g, torch.empty_like(g)),
                               sep_check=True)
        errs.append(err)
        print(f"slab mesh parity {shape} N={depth}: every shard within "
              f"{err:.3e} of its plain ring step, bitwise one device"
              f"{sep_text(sep)}")
    want = step_cuda_chunk(problem, dev, 280)(fp.clone())
    force_one = sharded_step.Diagnostics(problem, card_mesh((1, 1), dev)) \
        .force([[want]]).cpu().numpy()
    launches = {}
    for shape in ((2, 1), (1, 2), (2, 2)):
        mesh = card_mesh(shape, dev)
        chunk = sharded_step.make_chunk_fn(problem, mesh, 280)
        reset_counts()
        blocks = chunk(sharded_step.split(mesh, fp))
        counts = ring_counts()
        got = gather(blocks)
        torch.cuda.synchronize()
        plan = mesh_plan_launches(problem, mesh, [280])
        require(torch.equal(got, want) and counts == plan
                and chunk.substeps == (1 if shape[1] > 1 else 4),
                f"slab mesh {shape}: {chunk.mode} N={chunk.substeps}, "
                f"{float((got - want).abs().max())} off one device, "
                f"launches {counts} not {plan}")
        force = sharded_step.Diagnostics(problem, mesh).force(
            blocks).cpu().numpy()
        np.testing.assert_allclose(force, force_one, **FORCES_TOL)
        launches[chunk.substeps] = (launches.get(chunk.substeps, 0)
                                    + sum(counts.values()))
        print(f"slab mesh {shape} 280 steps: {chunk.mode} at N="
              f"{chunk.substeps}, {sum(counts.values())} ring launches, "
              f"bitwise one device, force within "
              f"{float(np.abs(force - force_one).max()):.3e} of one "
              "device's")
        del blocks, got
    del fp, want
    torch.cuda.empty_cache()
    print(f"slab mesh phase 65: {time.perf_counter() - t0:.2f} s")
    return {"launches": launches, "err": max(errs)}


def slab_phases(dev, card: str, refs: dict | None = None) -> list[dict]:
    """Phases 63-66: the solid-slab channel. 63: slab-2048x512 under
    Bouzidi (qb 0.25, qt 0.75): its cut links counted, one step against
    the plain step from the initial and the perturbed state (the obstacle
    domain's library SEPARATION tolerances off, the source at
    SOURCE_CHECK_FORCE against the build without it), N = 2, 3, 4
    bitwise, 280 steps, the staircase table off, the main path
    (slab_main_path); the bounce-back and equilibrium builds, the moving
    top wall (no source) and the other collisions at SLAB_SMALL, each with
    a counted 280-step run; 64: tpulbm's gates (slab_gates); 65: the
    meshes (slab_mesh_phase); 66: timing against the walled channel's
    build. Returns the kernels' JSON entries."""
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda
    t_all = t0 = time.perf_counter()
    cell = SlabCell(dev, "slab bouzidi bgk")
    cells, links = link_count(cell.problem)
    require(cells == 2 * SLAB_NX, f"slab: {cells} link cells, not "
            f"{2 * SLAB_NX}")
    print(f"slab {SLAB_NX}x{SLAB_NY}: {cells} cells with a cut link "
          f"({links} links)")
    err = cell_parity(cell, True, advanced=False)
    staircase_miss(cell)
    launches = slab_main_path(dev, cell)
    # the walled channel's build at the same size and force, in the same
    # turns (PERF.md §6 rows 1-2)
    channel = make_problem(channel_params(
        nx=SLAB_NX, ny=SLAB_NY,
        body_force=(cell.problem.body_force[0], 0.0)))
    others = {"channel1": (step_cuda.make_local_step_cuda(channel, dev), 1),
              "channel4": (step_cuda.make_local_step_cuda_blocked(
                  channel, dev, 4), 4)}
    ms, b = cell_timing(cell, card, others=others)
    print(f"timing slab {SLAB_NX}x{SLAB_NY} on {card}: 1-step "
          f"{ms[1]:.5f} ms/step against the channel build's "
          f"{ms['channel1']:.5f} ({100 * (ms[1] / ms['channel1'] - 1):+.1f}%"
          f"), N=4 {ms[4]:.5f} against {ms['channel4']:.5f} "
          f"({100 * (ms[4] / ms['channel4'] - 1):+.1f}%)")
    entries = bz_entries(cell, {**launches, 2: 0, 3: 0}, err, ms, b)
    print(f"slab phase 63 ({SLAB_NX}x{SLAB_NY}): "
          f"{time.perf_counter() - t0:.2f} s")
    mesh = slab_mesh_phase(dev, card, cell)
    ring_t = bz_ring_timing(cell.problem, dev, card, cell.f0)
    lib = cell.library
    for r in ring_t:
        entries.append({
            "name": f"d2q9_rings_{r['mode']}"
                    + ("" if r["depth"] == 1 else f"_n{r['depth']}")
                    + f"[{lib}]",
            "route": "cuda",
            "source": (step_cuda.KERNEL_SOURCE if r["depth"] == 1
                       else step_cuda.BLOCKED_SOURCE),
            "replaces": step_cuda.rings_replaces(r["mode"], r["depth"]),
            "launches": mesh["launches"].get(r["depth"], 0),
            "max_abs_err": max(r["err"], mesh["err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    del cell
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    small = [("bounce_back", dict(bc="bounce_back")),
             ("equilibrium", dict(bc="equilibrium")),
             ("couette", dict(qb=0.9, qt=0.1, force=0.0,
                              moving=SLAB_U_MAX))]
    small += [(op, BZ_OPS[op]) for op in BZ_OPS if op != "bgk"]
    for label, kw in small:
        c = SlabCell(dev, f"slab {label}", **SLAB_SMALL, **kw)
        if c.problem.obstacle_bc == "bouzidi":
            link_count(c.problem)
        e = cell_parity(c, True, advanced=False, check_source=False,
                        drift=False)
        runs = counted_run(c)
        ms, b = cell_timing(c, card)
        new = (bz_entries if c.problem.obstacle_bc == "bouzidi"
               else cell_entries)(c, {**runs, 2: 0, 3: 0}, e, ms, b)
        entries += renamed(new, "moving") if label == "couette" else new
        del c
    torch.cuda.empty_cache()
    print(f"slab phase 63 ({SLAB_SMALL['nx']}x{SLAB_SMALL['ny']}): "
          f"{time.perf_counter() - t0:.2f} s")
    slab_gates(dev, refs)
    print(f"slab phases 63-66: {time.perf_counter() - t_all:.2f} s")
    return entries


def remainder_phases(dev, card: str, refs: dict | None = None) -> list[dict]:
    """Phases 61-66, the Bouzidi remainder (remainder_builds, built in
    phase 2, or here at first use); `refs` as slab_gates takes them.
    Returns the kernels' JSON entries."""
    from tpulbm_torch.ops import step_cuda
    from tpulbm_torch.utils import cuda_build
    t0 = time.perf_counter()
    for src, mode, variant in remainder_builds():
        lib = cuda_build.load(src, step_cuda.build_defines(mode, variant))
        print(f"build: {src} {step_cuda.build_defines(mode, variant)} in "
              f"{lib.build_seconds:.2f} s ({ptxas_summary(lib.log)})")
    bz27 = step_cuda.BOUZIDI | step_cuda.D3Q27
    smem = {n: step_cuda._blocked_library_3d("bgk", bz27)
            .tpulbm_d3q19_blocked_smem_bytes(n) for n in DEPTHS_3D}
    smem1 = step_cuda._library_3d("bgk", bz27).tpulbm_d3q19_smem_bytes()
    print(f"build: the D3Q27 Bouzidi N-step kernel's dynamic shared memory "
          f"per block {smem} B (a block may take 232,448 B); its 1-step "
          f"kernel's {smem1} B")
    entries = bz27_phases(dev, card) + slab_phases(dev, card, refs)
    print(f"remainder phases 61-66: {time.perf_counter() - t0:.2f} s")
    return entries


def gate_references():
    """(slab_problem keywords, steps) of phase 64's f32 plain-step
    references: the staircase pair and both Couette channels."""
    g, c = SLAB_GATE, COUETTE_GATE
    return ([(dict(nx=g["nx"], ny=g["ny"], bc=bc, force=g["force"]),
              g["steps"]) for bc in ("bouzidi", "bounce_back")]
            + [(dict(nx=c["nx"], ny=c["ny"], qb=qb, qt=qt, force=0.0,
                     moving=c["u"]), c["steps"])
               for qb, qt in ((0.25, 0.75), (0.9, 0.1))])


def plain_profile(kw: dict, steps: int) -> np.ndarray:
    """ux along y (x = 0) of slab_problem(**kw) after `steps` f32 plain
    steps on the host: phase 64's reference, computed in a process of its
    own beside the phases (at 24x8 the plain step is bound by its ~150
    operations' dispatch on any device)."""
    from tpulbm_torch import physics
    from tpulbm_torch.stepper import make_chunk_fn
    problem = slab_problem(**kw)
    f = torch.from_numpy(problem.initial_state())
    f = make_chunk_fn(problem, "cpu", steps, backend="jax")(f)
    _, u = physics.moments(problem.lattice, f.double())
    return u[0][:, 0].numpy()


def phase_builds(step_cuda) -> list:
    """Every library the phases run as cuda_build.load's (source, defines),
    in the order the phases first need them, the N-step sources (the
    longest builds) first within a phase group: the six sources, the
    collision-mode builds of phases 17-24, then the builds of phases
    25-29, 30-34, 35-40, 41-45, 46-50, 51-55, 56-60 and 61-66."""
    sources = ["step_d2q9.cu", "step_d2q9_blocked.cu", "step_d3q19.cu",
               "step_d3q19_blocked.cu", "step_thermal.cu",
               "step_multiphase.cu"]
    modes = [(src, step_cuda.mode_defines(mode))
             for mode in step_cuda.COLLISION_MODES[1:]
             for src in ("step_d2q9.cu", "step_d2q9_blocked.cu")]
    modes += [(src, step_cuda.mode_defines(mode))
              for mode in step_cuda.COLLISION_MODES_3D[1:]
              for src in ("step_d3q19.cu", "step_d3q19_blocked.cu")]
    modes += [("step_thermal.cu", step_cuda.mode_defines("smagorinsky"))]
    groups = [[(src, ()) for src in sources], modes]
    for builds in (new_builds, mesh_builds, box_builds, bz_builds,
                   box3d_builds, mesh3d_builds, coupled_builds,
                   remainder_builds):
        groups.append([(src, step_cuda.build_defines(mode, variant))
                       for src, mode, variant in builds()])
    jobs = []
    for group in groups:
        for job in sorted(group, key=lambda j: "_blocked" not in j[0]):
            if job not in jobs:
                jobs.append(job)
    return jobs


class Builds:
    """Phase 2: every library of phase_builds() compiled by nvcc in a pool
    of threads beside the phases, one nvcc each, twice as many as the cores
    but the first, which this process keeps for its own launches (the
    threads, and the nvcc they start, run on the others); cuda_build.load
    waits for a library still in the pool instead of building it a second
    time. report() prints every build once all are done."""

    def __init__(self, jobs: list):
        from tpulbm_torch.utils import cuda_build
        self.t0 = time.perf_counter()
        self.last = 0.0
        cpus = sorted(os.sched_getaffinity(0))
        spare = set(cpus[1:]) or set(cpus)
        self.workers = 2 * len(spare)
        self.pool = ThreadPoolExecutor(
            self.workers, initializer=os.sched_setaffinity,
            initargs=(0, spare))
        self.load = cuda_build.load
        self.futures = {}
        for job in jobs:
            fut = self.pool.submit(self.load, *job)
            fut.add_done_callback(self._done)
            self.futures[job] = fut
        cuda_build.load = self._wait

    def _done(self, _fut) -> None:
        self.last = time.perf_counter() - self.t0

    def _wait(self, source: str, defines: tuple = ()):
        fut = self.futures.get((source, tuple(defines)))
        return fut.result() if fut is not None else self.load(source,
                                                              defines)

    def close(self, cancel: bool = False) -> None:
        """Stop the pool (its builds not yet started dropped with
        `cancel`) and give cuda_build back its own load."""
        from tpulbm_torch.utils import cuda_build
        self.pool.shutdown(wait=True, cancel_futures=cancel)
        cuda_build.load = self.load

    def report(self, step_cuda) -> None:
        libs = {job: fut.result() for job, fut in self.futures.items()}
        print(f"build: {len(libs)} libraries (6 sources, their collision "
              f"modes, the domain, source, obstacle and ring builds), "
              f"{self.workers} nvcc at a time beside the phases, the last "
              f"done {self.last:.2f} s after the pool started; "
              f"{sum(lib.build_seconds for lib in libs.values()):.2f} s of "
              "nvcc in all")
        for (src, defines), lib in libs.items():
            print(f"build: {src} {defines} in {lib.build_seconds:.2f} s "
                  f"({ptxas_summary(lib.log)})")


def step_cuda_chunk(problem, dev, steps: int):
    """The one-device kernel chunk of `steps` steps (stepper.make_chunk_fn)
    under the current environment."""
    from tpulbm_torch.stepper import make_chunk_fn
    return make_chunk_fn(problem, dev, steps)


def main() -> int:
    t_start = time.perf_counter()
    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from tpulbm_torch.ops import step_cuda

    shutil.rmtree(OUT_DIR, ignore_errors=True)   # runs start from t = 0

    # phase 2: build from the checkout's sources: every library the phases
    # run, in a pool beside them (Builds); phase 64's f32 plain-step
    # references in two host processes of their own
    builds = Builds(phase_builds(step_cuda))
    refs_pool = ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"),
        initializer=torch.set_num_threads, initargs=(1,))
    refs = {(tuple(sorted(kw.items())), n): refs_pool.submit(
        plain_profile, kw, n) for kw, n in gate_references()}
    print(f"build: {len(builds.futures)} libraries in a pool of "
          f"{builds.workers} nvcc beside the phases")
    try:
        kernels = run_phases(dev, card, t_start, refs)
        builds.report(step_cuda)
    finally:
        builds.close(cancel=True)
        refs_pool.shutdown(wait=True, cancel_futures=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.2f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(dev, card: str, t_start: float, refs: dict) -> list[dict]:
    """Phases 2 (its shared-memory report) to 66; returns the kernels' JSON
    entries. `refs`: phase 64's plain references (gate_references) as
    futures."""
    from tpulbm_torch.config import PRESETS
    from tpulbm_torch.models import make_problem
    from tpulbm_torch.ops import step_cuda, step_torch
    from tpulbm_torch.runner import Runner

    smem = {n: step_cuda._blocked_library().tpulbm_d2q9_blocked_smem_bytes(n)
            for n in DEPTHS}
    print(f"build: N-step kernel dynamic shared memory per block {smem} B")
    smem3 = {n: step_cuda._blocked_library_3d()
             .tpulbm_d3q19_blocked_smem_bytes(n) for n in DEPTHS_3D}
    print(f"build: D3Q19 kernel dynamic shared memory per block "
          f"{step_cuda._library_3d().tpulbm_d3q19_smem_bytes()} B, N-step "
          f"D3Q19 kernel {smem3} B")

    # phase 3: the kernels against plain at the main path's shape
    params = PRESETS["re200"].replace(precision="f32", enable_vtk=False)
    problem = make_problem(params)
    kstep = step_cuda.make_local_step_cuda(problem, dev)
    pstep = step_torch.make_step_rolled(problem, dev)
    f0 = initial_state(problem, dev)

    def one_step_err(f: torch.Tensor) -> float:
        got = kstep(f, torch.empty_like(f))
        want = pstep(f)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **ONE_STEP_TOL)
        return float((got - want).abs().max())

    err_init = one_step_err(f0)
    f500 = plain_chunk(pstep, f0.clone(), 500)
    err_500 = one_step_err(f500)
    print(f"parity 1 step at {params.nx}x{params.ny}: max abs err "
          f"{err_init:.3e} from the initial state, {err_500:.3e} after 500 "
          f"plain steps (rtol 5e-6, atol 1e-7)")
    fk = kernel_chunk(kstep, f0.clone(), 280)
    fp = plain_chunk(pstep, f0.clone(), 280)
    torch.cuda.synchronize()
    err_280 = float((fk - fp).abs().max())
    require(np.isfinite(err_280) and err_280 < DRIFT_280_BOUND,
            f"280-step drift {err_280} beyond {DRIFT_280_BOUND}")
    print(f"parity 280 steps: max abs err {err_280:.3e} "
          f"(bound {DRIFT_280_BOUND})")

    bsteps = {n: step_cuda.make_local_step_cuda_blocked(problem, dev, n)
              for n in DEPTHS}
    err_plain = {}
    for n in DEPTHS:
        errs = []
        for name, f in (("initial", f0), ("500 plain steps", f500)):
            got = bsteps[n](f, torch.empty_like(f))
            want = kernel_chunk(kstep, f.clone(), n)
            want_plain = plain_chunk(pstep, f.clone(), n)
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            require(diff == 0.0 and torch.equal(got, want),
                    f"N={n} from {name}: {diff} off N 1-step launches")
            torch.testing.assert_close(got, want_plain, **n_step_tol(n))
            errs.append(float((got - want_plain).abs().max()))
        err_plain[n] = max(errs)
        print(f"parity N={n}: max abs diff 0.0 against {n} 1-step launches "
              f"from both states (bitwise); against {n} plain steps "
              f"{errs[0]:.3e} / {errs[1]:.3e} (rtol {n_step_tol(n)['rtol']:.0e}"
              f", atol {n_step_tol(n)['atol']:.0e})")
    f4 = kernel_chunk(bsteps[4], f0.clone(), 70)
    torch.cuda.synchronize()
    diff_280 = float((f4 - fk).abs().max())
    require(diff_280 == 0.0 and torch.equal(f4, fk),
            f"70 N=4 launches {diff_280} off 280 1-step launches")
    print("parity 280 steps: 70 N=4 launches equal 280 1-step launches "
          "(max abs diff 0.0)")
    err_tiny = tiny_runner_agreement(dev)
    print(f"runner 64x32, kernel vs plain: forces max abs diff "
          f"{err_tiny:.3e} (rtol 1e-4, atol 5e-6)")

    # phase 4: the main path, counted
    run_dir = OUT_DIR / "re200"
    main_params = params.replace(num_timesteps=2800, output_frequency=140,
                                 output_dir=str(run_dir))
    result, counts, wall = run_counted(main_params, dev)
    require(counts == {**only(4, 665), 1: 140},
            f"launch counts {counts}, not 665 N=4, 140 1-step and 0 "
            "others")
    forces = check_forces(run_dir, list(range(0, 2800, 140)))
    field = np.loadtxt(run_dir / "velocity_field.csv", delimiter=",",
                       skiprows=1)
    require(field.shape == (params.nx * params.ny, 6),
            f"velocity_field.csv shape {field.shape}")
    require(bool(np.isfinite(field).all()), "velocity_field.csv not finite")
    print(f"main path: re200 {params.nx}x{params.ny} f32, 2800 steps, "
          f"launches {counts[4]} N=4 + {counts[1]} 1-step "
          f"(N=2: {counts[2]}, N=3: {counts[3]}), {result.host_fetches} "
          f"host fetches in the loop, {wall:.2f} s wall, runner "
          f"{result.mlups:.1f} MLUPS, final C_D {forces[-1, 3]:.6f}")
    main_counts = counts

    # phase 4b: checkpoint at t = 1119, resume to 2800
    res_dir = OUT_DIR / "re200_resumed"
    first = main_params.replace(num_timesteps=1120, checkpoint_every=8,
                                output_dir=str(res_dir))
    require(Runner(first, device=dev, verbose=False).run().success,
            "the 1120-step run failed")
    ckpts = sorted(os.listdir(res_dir / "checkpoints"))
    require(ckpts == ["ckpt_000001119.npz"], f"checkpoints {ckpts}")
    resumed = Runner(first.replace(num_timesteps=2800), device=dev,
                     verbose=False).run(resume=True)
    require(resumed.success and resumed.final_step == 2800, "resume failed")
    require(same_files(run_dir, res_dir, ["forces.csv",
                                          "velocity_field.csv"]),
            "the resumed run's artifacts differ from the straight run's")
    print(f"resume: checkpoint {ckpts[0]}, resumed to 2800 in "
          f"{resumed.wall_seconds:.2f} s; forces.csv and velocity_field.csv "
          f"byte-identical to the straight run")

    # phase 4c: N=3 and N=2 through the Runner, against blocking off
    d23 = OUT_DIR / "re200_f150"
    p23 = params.replace(num_timesteps=311, output_frequency=150,
                         output_dir=str(d23))
    _, counts23, _ = run_counted(p23, dev)
    require(counts23 == {**only(3, 100), 1: 1, 2: 5},
            f"launch counts {counts23}, not 100 N=3, 5 N=2, 1 1-step")
    check_forces(d23, [0, 150, 300])
    d1 = OUT_DIR / "re200_f150_unblocked"
    os.environ["TPULBM_NO_FUSED2"] = "1"
    try:
        require(Runner(p23.replace(output_dir=str(d1)), device=dev,
                       verbose=False).run().success, "unblocked run failed")
    finally:
        del os.environ["TPULBM_NO_FUSED2"]
    require(same_files(d23, d1, ["forces.csv", "velocity_field.csv"]),
            "N=3/N=2 run differs from the same run with blocking off")
    print(f"depths 3 and 2: 311 steps every 150, launches {counts23[3]} "
          f"N=3 + {counts23[2]} N=2 + {counts23[1]} 1-step; artifacts "
          f"byte-identical to the 1-step-only run")

    # phase 5: timing, in turns; ms per step (one launch is N steps)
    n_kernel, n_plain = 2400, PLAIN_2D_STEPS
    runs = {"plain": lambda f, n: plain_chunk(pstep, f, n),
            1: lambda f, n: kernel_chunk(kstep, f, n)}
    for n in DEPTHS:
        runs[n] = lambda f, steps, n=n: kernel_chunk(bsteps[n], f, steps // n)
    order = ["plain", 1, *DEPTHS]
    times = {k: [] for k in order}
    for which in order + order[::-1]:
        steps = n_plain if which == "plain" else n_kernel
        times[which].append(ms_per_step(runs[which], f0, steps, PLAIN_WARM
                                        if which == "plain" else 20))
    ms = {k: min(v) for k, v in times.items()}
    cells = params.nx * params.ny
    print(f"timing at {params.nx}x{params.ny} on {card}, ms/step (MLUPS): "
          + "; ".join(f"{'plain' if k == 'plain' else f'N={k}'} "
                      f"{ms[k]:.5f} ({cells / ms[k] / 1e3:.1f}, runs "
                      f"{[round(v, 6) for v in times[k]]})" for k in order))
    print(f"timing: the cylinder's BGK N=4 kernel {ms[4]:.5f} ms/step, "
          f"{100 * (ms[4] / RE200_N4_BEFORE_MS - 1):+.2f}% against "
          f"{RE200_N4_BEFORE_MS} ms/step before the ring builds (PERF.md "
          "§6, row 2; NVIDIA H100 80GB HBM3, 700.00 W)")

    kernels = [{
        "name": "d2q9_collide_stream", "route": "cuda",
        "source": step_cuda.KERNEL_SOURCE, "replaces": step_cuda.REPLACES,
        "launches": main_counts[1], "max_abs_err": max(err_init, err_500),
        "ms": ms[1], "plain_ms": ms["plain"], **bound("d2q9", cells)}]
    for n in DEPTHS:
        kernels.append({
            "name": f"d2q9_collide_stream_n{n}", "route": "cuda",
            "source": step_cuda.BLOCKED_SOURCE,
            "replaces": step_cuda.BLOCKED_REPLACES[n],
            "launches": (main_counts if n == 4 else counts23)[n],
            "max_abs_err": err_plain[n], "ms": ms[n],
            "plain_ms": ms["plain"], **bound("d2q9", cells, n)})
    groups = [("6-8", sphere_phases), ("9-12", thermal_phases),
              ("13-16", multiphase_phases), ("17-20", operator_phases),
              ("21-23", sphere_operator_phases), ("24", thermal_les_phases),
              ("25-29", domain_phases), ("30-34", mesh_phases),
              ("35-40", box_phases), ("41-45", bouzidi_phases),
              ("46-50", box3d_phases), ("51-55", mesh3d_phases),
              ("56-60", coupled_mesh_phases),
              ("61-66", lambda d, c: remainder_phases(d, c, refs))]
    print(f"chip_smoke: {time.perf_counter() - t_start:.2f} s after phases "
          "1-5")
    for names, phases in groups:
        new = phases(dev, card)
        kernels.extend(new if isinstance(new, list) else [new])
        print(f"chip_smoke: {time.perf_counter() - t_start:.2f} s after "
              f"phases {names}")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
