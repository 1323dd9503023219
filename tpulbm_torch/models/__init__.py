"""Problem builders. The port covers the 2-D D2Q9 cylinder under every
collision operator (BGK, TRT, MRT, regularized, KBC, Smagorinsky, power
law) with either Zou-He corner rule, the body-forced Poiseuille channel
and the lid-driven cavity under the same operators, the 3-D sphere in a
duct and the 3-D Poiseuille duct on D3Q19 or D3Q27 under each of those
but KBC (and MRT on D3Q27, which tpulbm refuses), the
equilibrium, the bounce-back or the Bouzidi curved-wall obstacle (the
cylinder also spinning; Bouzidi on D3Q19 only) and a uniform body force
on any of them, the
2-D thermal problems (Rayleigh-Bénard and the side-heated cavity, BGK or
the Smagorinsky closure), the Shan-Chen multiphase
channel (droplet or band, BGK), the fully periodic 2-D boxes
(Taylor-Green, the shear layer and Kolmogorov under every D2Q9
collision, the passive scalar under the thermal step's) and the 3-D
boxes (Taylor-Green and Kolmogorov on D3Q19 or D3Q27), every one of them
also on a mesh of shards; every other
configuration raises
NotImplementedError naming the ROADMAP item (Queue 1) that will port it,
and the combinations tpulbm itself refuses (KBC in 3-D, a 3-D cavity)
raise its ValueError, as does a Bouzidi obstacle without an analytic
surface (ops/bouzidi.link_q)."""
from ..config import check_collision
from .base import Problem
from . import (cavity, cylinder, cylinder3d, multiphase, periodic2d,
               poiseuille, rayleigh_benard)

__all__ = ["Problem", "make_problem"]

_BUILDERS = {"cylinder": cylinder.make_problem,
             "poiseuille": poiseuille.make_problem,
             "cavity": cavity.make_problem,
             "cylinder3d": cylinder3d.make_problem,
             "rayleigh-benard": rayleigh_benard.make_problem,
             "heated-cavity": rayleigh_benard.make_problem,
             "multiphase": multiphase.make_problem,
             **dict.fromkeys(periodic2d.PROBLEMS, periodic2d.make_problem)}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tpulbm_torch yet "
                               f"(ROADMAP {item})")


def check_slice(params) -> None:
    """Raise NotImplementedError for physics outside the ported slices,
    and tpulbm's ValueError for the combinations tpulbm refuses."""
    if params.problem not in _BUILDERS:
        raise ValueError(f"unknown problem: {params.problem!r}")
    three_d = "Queue 1 item 16 (3-D)"
    if params.problem == "cylinder" and params.is_3d:
        raise _not_ported("a 3-D cylinder (nz > 0)", three_d)
    if (params.is_3d and params.lattice3d == "d3q27"
            and params.obstacle_bc == "bouzidi"):
        raise _not_ported("the Bouzidi obstacle on D3Q27", three_d)
    if params.problem in periodic2d.PROBLEMS:
        periodic2d.check_2d(params)
    # the cylinders, the channel, the cavity and the duct run every
    # collision operator tpulbm runs for them, the thermal problems BGK and
    # the Smagorinsky closure, multiphase BGK: the rest raise tpulbm's own
    # errors
    check_collision(params)


def make_problem(params) -> Problem:
    """Build the Problem for params.problem ("cylinder", "poiseuille",
    "cavity", "cylinder3d", "rayleigh-benard", "heated-cavity",
    "multiphase", "taylor-green", "shear-layer", "kolmogorov" or
    "passive-scalar")."""
    check_slice(params)
    return _BUILDERS[params.problem](params)
