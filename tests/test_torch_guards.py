"""Guards of the port: it never imports jax or tpulbm, it never falls back
from the GPU to the CPU, and the kernel wrapper checks its inputs before
any launch."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from tpulbm_torch.config import SimulationParams
from tpulbm_torch.ops import step_cuda
from tpulbm_torch.runner import Runner
from tpulbm_torch.utils import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_runs_without_jax(tmp_path):
    # a fresh interpreter: import every module of the port, run a 10-step
    # chunk (N=2) and a super-chunk through the kernel modules' CPU path,
    # the CLI end to end, checkpointed and resumed, a tiny 3-D run, a
    # tiny heated cavity and a tiny multiphase band; neither jax nor tpulbm
    # may be loaded after it
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import tpulbm_torch
        for m in pkgutil.walk_packages(tpulbm_torch.__path__, "tpulbm_torch."):
            importlib.import_module(m.name)
        from tpulbm_torch.config import SimulationParams
        from tpulbm_torch.convert import state_from_numpy
        from tpulbm_torch.models import make_problem
        from tpulbm_torch.stepper import make_chunk_fn, make_super_chunk_fn
        from tpulbm_torch.__main__ import main
        problem = make_problem(SimulationParams(nx=48, ny=24))
        f = state_from_numpy(problem.initial_state(), problem, "cpu")
        chunk = make_chunk_fn(problem, "cpu", 10)
        assert chunk.substeps == 2
        f = chunk(f)
        f, diags = make_super_chunk_fn(problem, "cpu", 4, 2)(f)
        assert bool(f.isfinite().all()) and bool(diags.isfinite().all())
        cli = ["--cpu", "--nx", "64", "--ny", "32", "--output-frequency",
               "20", "--no-vtk", "--checkpoint-every", "1",
               "--output-dir", {str(tmp_path)!r}]
        assert main(cli + ["--num-timesteps", "20"]) == 0
        assert main(cli + ["--num-timesteps", "40"]) == 0
        assert main(["--cpu", "--problem", "cylinder3d", "--nx", "16",
                     "--ny", "8", "--nz", "6", "--num-timesteps", "12",
                     "--output-frequency", "4", "--no-vtk", "--output-dir",
                     {str(tmp_path / "sphere")!r}]) == 0
        assert main(["--cpu", "--preset", "heated-cavity", "--nx", "12",
                     "--ny", "10", "--num-timesteps", "12",
                     "--output-frequency", "4", "--output-dir",
                     {str(tmp_path / "cavity")!r}]) == 0
        assert main(["--cpu", "--problem", "multiphase", "--shan-chen-g",
                     "-5", "--nx", "16", "--ny", "8", "--tau", "1.0",
                     "--inlet-velocity", "0", "--num-timesteps", "12",
                     "--output-frequency", "4", "--no-vtk", "--output-dir",
                     {str(tmp_path / "multiphase")!r}]) == 0
        leaked = sorted(m for m in sys.modules
                        if m in ("jax", "tpulbm")
                        or m.startswith(("jax.", "tpulbm.")))
        assert not leaked, leaked
        print("JAX-FREE OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX-FREE OK" in proc.stdout
    assert "Resuming from" in proc.stdout
    for name in ("forces.csv", "velocity_field.csv", "simulation_params.csv"):
        assert (tmp_path / name).exists()
    for name in ("forces.csv", "fields3d.npz"):
        assert (tmp_path / "sphere" / name).exists()
    assert "Domain: 16×8×6" in proc.stdout
    for name in ("nusselt.csv", "temperature_field.csv",
                 "velocity_field.csv"):
        assert (tmp_path / "cavity" / name).exists(), name
    assert not (tmp_path / "cavity" / "forces.csv").exists()
    assert (tmp_path / "multiphase" / "velocity_field.csv").exists()
    assert not (tmp_path / "multiphase" / "forces.csv").exists()


def _port_sources():
    pkg = os.path.join(REPO, "tpulbm_torch")
    for root, _, files in os.walk(pkg):
        yield from (os.path.join(root, f) for f in sorted(files)
                    if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_neither_jax_nor_tpulbm():
    # static: no import statement anywhere in the port or chip_smoke.py
    # names jax or tpulbm (the run above sees only the paths it takes)
    found = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, REPO), n) for n in names
                      if n.split(".")[0] in ("jax", "tpulbm")]
    assert not found, found
    assert sum(1 for _ in _port_sources()) > 20


def test_runner_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    params = SimulationParams(nx=64, ny=32, output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(params, device="cuda")


# the 3-D meshes run (tests/test_torch_mesh3d.py), and the thermal and
# multiphase meshes (tests/test_torch_mesh_thermal.py,
# test_torch_mesh_multiphase.py: test_runner_takes_thermal_and_
# multiphase_meshes below)
@pytest.mark.parametrize("override", [dict(precision="f64"),
                                      dict(problem="cylinder3d", nz=16,
                                           lattice3d="d3q27",
                                           obstacle_bc="bouzidi",
                                           probe_points=((0.5, 0.5, 0.5),))])
def test_runner_refuses_unported_options(tmp_path, override):
    params = SimulationParams(nx=64, ny=32, num_timesteps=20,
                              output_dir=str(tmp_path), **override)
    with pytest.raises(NotImplementedError,
                       match="float32" if "precision" in override
                       else "ROADMAP"):
        Runner(params, device="cpu")


# refused until this slice's ring builds: the Runner builds their meshes
@pytest.mark.parametrize("override", [
    dict(mesh_shape=(2, 1), problem="rayleigh-benard", thermal_tau=0.6),
    dict(mesh_shape=(2, 1), problem="multiphase", shan_chen_g=-5.0, tau=1.0,
         inlet_velocity=0.0, stats_from=0)], ids=["thermal", "multiphase"])
def test_runner_takes_thermal_and_multiphase_meshes(tmp_path, override):
    params = SimulationParams(nx=64, ny=32, num_timesteps=20,
                              output_dir=str(tmp_path), **override)
    assert Runner(params, device="cpu").mesh.shape == (2, 1)


@pytest.mark.parametrize("no_resume", [True, False])
def test_cli_no_resume_starts_from_zero(tmp_path, capsys, no_resume):
    from tpulbm_torch.__main__ import main
    cli = ["--cpu", "--nx", "48", "--ny", "24", "--output-frequency", "10",
           "--no-vtk", "--checkpoint-every", "1", "--output-dir",
           str(tmp_path)]
    assert main(cli + ["--num-timesteps", "20"]) == 0
    assert (tmp_path / "checkpoints" / "ckpt_000000020.npz").exists()
    capsys.readouterr()
    assert main(cli + ["--num-timesteps", "30"]
                + (["--no-resume"] if no_resume else [])) == 0
    out = capsys.readouterr().out
    assert ("Resuming from" in out) == (not no_resume)
    steps = 30 if no_resume else 10
    assert f"over {steps} steps" in out


def _inputs(ny=6, nx=10):
    f = torch.rand(9, ny, nx, dtype=torch.float32)
    return f, torch.empty_like(f), torch.zeros(ny, nx, dtype=torch.uint8)


def test_kernel_wrapper_accepts_valid_inputs():
    step_cuda.check_inputs(*_inputs())


@pytest.mark.parametrize("bad,exc", [
    ("f64", TypeError), ("solid_bool", TypeError), ("q8", ValueError),
    ("out_shape", ValueError), ("solid_shape", ValueError),
    ("noncontig", ValueError), ("alias", ValueError), ("meta", ValueError)])
def test_kernel_wrapper_rejects_bad_inputs(bad, exc):
    f, out, solid = _inputs()
    if bad == "f64":
        f = f.double()
    elif bad == "solid_bool":
        solid = solid.bool()
    elif bad == "q8":
        f, out = f[:8].clone(), out[:8].clone()
    elif bad == "out_shape":
        out = out[:, :, :-1].clone()
    elif bad == "solid_shape":
        solid = solid[:-1].clone()
    elif bad == "noncontig":
        f = torch.rand(9, 10, 6).transpose(1, 2)
    elif bad == "alias":
        out = f
    elif bad == "meta":
        f, out, solid = (t.to("meta") for t in (f, out, solid))
    with pytest.raises(exc):
        step_cuda.check_inputs(f, out, solid)


def test_kernel_wrapper_counts_only_kernel_launches():
    # a CPU tensor runs the plain version: no kernel launch is counted
    from tpulbm_torch.models import make_problem
    problem = make_problem(SimulationParams(nx=40, ny=20))
    step = step_cuda.make_local_step_cuda(problem, "cpu")
    before = step_cuda.launches(step_cuda.collide_stream)
    f = torch.from_numpy(problem.initial_state())
    out = step(f, torch.empty_like(f))
    assert bool(out.isfinite().all())
    assert step_cuda.launches(step_cuda.collide_stream) == before


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(os.path, "exists", lambda p: not p.endswith("nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.find_nvcc()
