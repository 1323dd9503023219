"""Problem builders. The port covers the 2-D D2Q9 BGK cylinder with the
equilibrium obstacle; every other configuration raises NotImplementedError
naming the ROADMAP item (Queue 1) that will port it."""
from .base import Problem
from . import cylinder

__all__ = ["Problem", "make_problem"]

_PROBLEM_ITEMS = {
    "poiseuille": "Queue 1 item 12 (body force, cavity and BC variants)",
    "cavity": "Queue 1 item 12 (body force, cavity and BC variants)",
    "taylor-green": "Queue 1 item 13 (periodic boxes and Kolmogorov)",
    "shear-layer": "Queue 1 item 13 (periodic boxes and Kolmogorov)",
    "kolmogorov": "Queue 1 item 13 (periodic boxes and Kolmogorov)",
    "passive-scalar": "Queue 1 item 17 (thermal and passive scalar)",
    "rayleigh-benard": "Queue 1 item 17 (thermal and passive scalar)",
    "heated-cavity": "Queue 1 item 17 (thermal and passive scalar)",
    "cylinder3d": "Queue 1 item 16 (3-D)",
    "multiphase": "Queue 1 item 18 (Shan-Chen multiphase)",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tpulbm_torch yet "
                               f"(ROADMAP {item})")


def check_slice(params) -> None:
    """Raise NotImplementedError for physics outside the ported slice."""
    if params.problem in _PROBLEM_ITEMS:
        raise _not_ported(f"problem={params.problem!r}",
                          _PROBLEM_ITEMS[params.problem])
    if params.problem != "cylinder":
        raise ValueError(f"unknown problem: {params.problem!r}")
    if params.is_3d:
        raise _not_ported("a 3-D cylinder (nz > 0)", "Queue 1 item 16 (3-D)")
    ops = "Queue 1 item 11 (collision operators)"
    if params.collision != "bgk":
        raise _not_ported(f"collision={params.collision!r}", ops)
    if params.smagorinsky:
        raise _not_ported("the Smagorinsky LES closure", ops)
    if params.power_law_n != 1.0:
        raise _not_ported("power-law rheology", ops)
    variants = "Queue 1 item 12 (body force, cavity and BC variants)"
    if params.obstacle_bc == "bouzidi":
        raise _not_ported("obstacle_bc='bouzidi'",
                          "Queue 1 item 14 (Bouzidi curved walls)")
    if params.obstacle_bc != "equilibrium":
        raise _not_ported(f"obstacle_bc={params.obstacle_bc!r}", variants)
    if params.zou_he_corners != "reference":
        raise _not_ported(f"zou_he_corners={params.zou_he_corners!r}",
                          variants)
    if params.body_force:
        raise _not_ported("a body force", variants)


def make_problem(params) -> Problem:
    """Build the Problem for params.problem (only "cylinder" is ported)."""
    check_slice(params)
    return cylinder.make_problem(params)
