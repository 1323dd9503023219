"""tpulbm_torch — the PyTorch + CUDA port of tpulbm for NVIDIA Hopper GPUs.

The port mirrors tpulbm's module names so each module's counterpart is easy
to find. Plain tensor code is PyTorch; the fused collide-stream steps are
hand-written CUDA kernels (csrc/*.cu) built with nvcc at first use. The
port imports neither jax nor tpulbm: it keeps its own copies of tpulbm's
host modules (config, lattice, geometry, utils.io, utils.checkpoint), held
to the originals by tests/test_torch_compat.py, so parameters, checkpoints
and artifacts move between the two packages unchanged.

Covered so far, on one device: the 2-D D2Q9 BGK cylinder main path
(Zou-He inlet/outlet, bounce-back y walls, equilibrium obstacle), the
3-D D3Q19 BGK sphere in a duct (equilibrium inlet, zero-gradient outlet,
bounce-back y and z walls, equilibrium obstacle), the 2-D thermal
problems (D2Q9 flow + D2Q5 temperature, Boussinesq): Rayleigh-Bénard and
the side-heated cavity, and Shan-Chen multiphase flow (a droplet or a
liquid band in an x-periodic channel with exact-mass walls, the walls'
wettability set by a phantom wall density). Anything else raises
NotImplementedError naming its ROADMAP item.

    python -m tpulbm_torch --preset re200 --no-vtk
    python -m tpulbm_torch --problem cylinder3d --nx 256 --ny 256 --nz 256 \\
        --inlet-velocity 0.05 --no-vtk
    python -m tpulbm_torch --preset rayleigh-benard --nx 2048 --ny 512 --no-vtk
    python -m tpulbm_torch --problem multiphase --shan-chen-g -5 \\
        --tau 1.0 --inlet-velocity 0 --cylinder-radius 0.15 --no-vtk
"""
