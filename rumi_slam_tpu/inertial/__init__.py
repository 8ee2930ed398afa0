"""Visual-inertial subsystem (JAX equivalent of the reference's
ImuTypes.cc / G2oTypes.cc / Optimizer.cc inertial paths).

The reference compiles full ORB-SLAM3 inertial support into the library even
though the RUMI monocular configuration leaves it unused (SURVEY.md §2.1,
ImuTypes.cc:1-421, G2oTypes.cc:1-863).  We provide the same capability
surface: IMU preintegration with bias Jacobians (`preintegration`), and the
inertial initialization / visual-inertial BA problem builders
(`inertial_ba`).
"""

from . import inertial_ba, preintegration  # noqa: F401
