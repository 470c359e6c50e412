"""Initial-condition configuration enum.

Mirrors the reference's ``NBodyConfig`` (src/nbody/nbody_config.hpp:3):
three generators — uniform-ball RANDOM, rotating SHELL, radial EXPAND — plus
PLUMMER, a self-consistent equilibrium sphere the reference lacks (its demos
are all far-from-equilibrium transients; an equilibrium model is the standard
astrophysical validation target, see ``ic.py``).
"""

import enum


class NBodyConfig(enum.Enum):
    RANDOM = "random"
    SHELL = "shell"
    EXPAND = "expand"
    PLUMMER = "plummer"

    @classmethod
    def parse(cls, name: str) -> "NBodyConfig":
        try:
            return cls(name.lower())
        except ValueError:
            raise ValueError(
                f"unknown initial condition {name!r}; "
                f"expected one of {[c.value for c in cls]}"
            ) from None
