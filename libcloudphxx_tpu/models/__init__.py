"""Host models — acceptance vehicles for the three microphysics schemes.

JAX equivalent of reference models/ (the 2-D kinematic "icicle"
driver, models/kinematic_2D/).
"""

from . import kinematic_2d, mpdata
from .kinematic_2d import Kinematic2D, Setup

__all__ = ["Kinematic2D", "Setup", "kinematic_2d", "mpdata"]
