from fermiflow_tpu_torch.physics.base_dist import FreeFermion
from fermiflow_tpu_torch.physics.orbitals import HO2D, hermite_functions
from fermiflow_tpu_torch.physics.potentials import (
    CoulombPairPotential,
    HOPotential,
    pairwise_distances,
)

__all__ = [
    "FreeFermion",
    "HO2D",
    "hermite_functions",
    "CoulombPairPotential",
    "HOPotential",
    "pairwise_distances",
]
