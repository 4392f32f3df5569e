"""Angular quadrature sets for the J integral.

Data: unpolarised-light quadratures of Jaume Bestard & Trujillo Bueno (2021),
retrieved by the reference from CDS (J/A+A/645/A101) and shipped as
quadratures/*.dat (rows: weight, theta[deg], phi[deg]; see
src/functions.jl:26-63 `read_quadrature`).  The same published tables are
vendored here as numeric data.

Conventions (mirroring src/lambda_iteration.jl:23-27):
  k = [cos(theta), cos(phi) sin(theta), sin(phi) sin(theta)]  (z, x, y)
  theta > 90 deg  => ray moves UP   (k_z < 0 ... note k points toward the
                     propagation direction; upward sweeps start from the
                     bottom boundary with I_0 = B_lambda(T_bottom))
  theta < 90 deg  => ray moves DOWN (top boundary, I_0 = 0)
Weights sum to 1 over the full set.

The port's own copy of voronoirt_tpu/quadrature.py, which imports no jax:
the port imports nothing of the JAX package.  tests/test_torch_host_copies.py
holds the two equal.
"""

from __future__ import annotations

import dataclasses
import numpy as np

# name -> rows of (weight, theta_deg, phi_deg)
_TABLES = {
    "n1": [
        (1.0, 180.0, 0.0),
    ],
    "n2": [
        (0.5, 180.0, 0.0),
        (0.5, 0.0, 0.0),
    ],
    "ul2n3": [
        (0.443443991879947, 130.216959552587923, 87.140406432445261),
        (0.297353289142357, 56.150446041264999, 33.699614660475369),
        (0.259202718977696, 62.248488996038418, 194.232281826569306),
    ],
    "ul7n12": [
        (0.062174023651822, 70.292581108446825, 346.412955051617416),
        (0.062174023651822, 109.707418891553175, 193.587044948382584),
        (0.078304613457687, 152.666292044518485, 315.475247829748128),
        (0.078304613457687, 27.333707955481518, 135.475247829748128),
        (0.090740740740741, 147.207528953818269, 135.743688985642649),
        (0.090740740740741, 67.175739518129632, 155.790538127899197),
        (0.090740740740741, 32.792471046181731, 44.256311014357351),
        (0.090740740740741, 112.824260481870382, 335.790538127899197),
        (0.084923207761833, 101.810709392034880, 235.428463450411130),
        (0.084923207761833, 78.189290607965106, 55.428463450411122),
        (0.093116673647177, 65.132900950498197, 260.165664821292125),
        (0.093116673647177, 114.867099049501803, 80.165664821292154),
    ],
    "ul9n20": [
        (0.042900863447492, 115.946219419914584, 166.340315877463212),
        (0.042900863447492, 64.053780580085430, 346.340315877463240),
        (0.040388502199506, 48.073243098616757, 165.361251013223807),
        (0.040388502199506, 131.926756901383243, 14.638748986776188),
        (0.046234879402759, 29.259863413046077, 27.017098561225936),
        (0.046234879402758, 150.740136586953952, 207.017098561225879),
        (0.049703707329554, 162.031810523263061, 54.079377867153241),
        (0.049703707329554, 17.968189476736974, 125.920622132846674),
        (0.046238618174993, 137.910284713268055, 260.244359781572030),
        (0.046238618174993, 42.089715286732030, 80.244359781572001),
        (0.048938850334462, 117.741416423787385, 226.408937057340268),
        (0.048938850334462, 62.258583576212644, 46.408937057340282),
        (0.054976307502811, 107.082798615968500, 91.438688384734320),
        (0.054976307502811, 72.917201384031571, 88.561311615265694),
        (0.054466758865998, 92.185687680639404, 303.690824724379354),
        (0.054466758865999, 87.814312319360653, 123.690824724379354),
        (0.054221275413118, 54.524830794767126, 233.419962308359743),
        (0.054221275413118, 125.475169205232916, 306.580037691640257),
        (0.061930237329307, 82.319913662354864, 199.223240729190280),
        (0.061930237329307, 97.680086337645136, 340.776759270809691),
    ],
}


@dataclasses.dataclass(frozen=True)
class Quadrature:
    """An angular quadrature: weights + unit direction vectors."""
    name: str
    weights: np.ndarray      # (n,) float64
    theta_deg: np.ndarray    # (n,)
    phi_deg: np.ndarray      # (n,)

    @property
    def n_angles(self) -> int:
        return len(self.weights)

    @property
    def k(self) -> np.ndarray:
        """Unit propagation vectors, rows (k_z, k_x, k_y).

        Matches src/lambda_iteration.jl:26.
        """
        th = np.deg2rad(self.theta_deg)
        ph = np.deg2rad(self.phi_deg)
        return np.stack(
            [np.cos(th), np.cos(ph) * np.sin(th), np.sin(ph) * np.sin(th)],
            axis=-1,
        )

    @property
    def is_up(self) -> np.ndarray:
        """True where the ray sweeps upward (theta > 90 deg)."""
        return self.theta_deg > 90.0


def get_quadrature(name: str) -> Quadrature:
    """Load a vendored quadrature by name (e.g. 'ul7n12').

    Accepts either the bare name or a path-like string ending in
    '<name>.dat' for drop-in compatibility with reference drivers.
    """
    key = name
    if key.endswith(".dat"):
        key = key.rsplit("/", 1)[-1][: -len(".dat")]
    if key not in _TABLES:
        raise KeyError(f"unknown quadrature {name!r}; have {sorted(_TABLES)}")
    rows = np.asarray(_TABLES[key], dtype=np.float64)
    return Quadrature(key, rows[:, 0], rows[:, 1], rows[:, 2])
