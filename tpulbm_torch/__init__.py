"""tpulbm_torch — the PyTorch + CUDA port of tpulbm for NVIDIA Hopper GPUs.

The port mirrors tpulbm's module names so each module's counterpart is easy
to find. Plain tensor code is PyTorch; the fused collide-stream step is a
hand-written CUDA kernel (csrc/step_d2q9.cu) built with nvcc at first use.
tpulbm's jax-free host modules (config, lattice, geometry, utils.io) are
re-exported, not copied, so one SimulationParams type and one set of
artifact writers serve both packages.

Covered so far: the 2-D D2Q9 BGK cylinder main path on one device
(Zou-He inlet/outlet, bounce-back y walls, equilibrium obstacle). Anything
else raises NotImplementedError naming its ROADMAP item.

    python -m tpulbm_torch --preset re200 --no-vtk
"""
