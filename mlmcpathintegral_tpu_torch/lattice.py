"""1-D lattice metadata and the 2-D coarsening modes (a copy of
``mlmcpathintegral_tpu/lattice.py``'s ``Lattice1D`` and ``CoarsenType`` so
that the PyTorch package stands alone).

Reference parity: src/lattice/lattice1d.{hh,cc}: M_lat sites on
[0, T_final], a = T/M, periodic; coarse_lattice halves M
(lattice1d.hh:80-89).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class CoarsenType(Enum):
    """2-D coarsening modes (lattice2d.hh:18-26)."""
    BOTH = "both"            # halve both directions
    TEMPORAL = "temporal"    # halve temporal direction only
    SPATIAL = "spatial"      # halve spatial direction only
    ALTERNATE = "alternate"  # alternate temporal/spatial per level
    ROTATE = "rotate"        # rotate by 45 degrees, halve site count


@dataclass(frozen=True)
class Lattice1D:
    """Periodic 1-D lattice with M_lat sites on [0, T_final]."""
    M_lat: int
    T_final: float
    coarsening_level: int = 0

    def __post_init__(self):
        if self.M_lat < 2:
            raise ValueError(f"M_lat must be >= 2, got {self.M_lat}")

    @property
    def a_lat(self) -> float:
        return self.T_final / self.M_lat

    @property
    def ndof(self) -> int:
        return self.M_lat

    def coarse_lattice(self) -> "Lattice1D":
        if self.M_lat % 2:
            raise ValueError(
                f"cannot coarsen lattice with odd M_lat={self.M_lat}")
        return Lattice1D(self.M_lat // 2, self.T_final,
                         self.coarsening_level + 1)

    def fine_lattice(self) -> "Lattice1D":
        return Lattice1D(self.M_lat * 2, self.T_final,
                         self.coarsening_level - 1)

    def __str__(self):
        return (f"Lattice1D(M={self.M_lat}, T={self.T_final}, "
                f"a={self.a_lat:.6f}, level={self.coarsening_level})")
