"""Regular-grid model atmosphere: container, HDF5 loader, synthetic generator.

Reference parity: src/atmosphere.jl -- `Atmosphere` struct (:22-54),
`get_atmos` Bifrost HDF5 loader with axis-ascending normalization and
`skip` striding (:64-158), periodic ghost layers (:166-264).

Axis order: fields are [z, x, y]; z/x/y are 1-D ascending axes.  The x,y
axes are equidistant (asserted), which is what makes every sweep stencil
static (SURVEY.md §7).

The Bifrost snapshot used by the reference is not shipped with it
(data/README: "No data is pushed here"); `synthetic_atmosphere` provides
a smooth FAL-C-like stratification + sinusoidal perturbations so the full
NLTE path can be exercised hermetically (SURVEY.md §4.5).

The port's own copy of voronoirt_tpu/atmosphere.py, which imports no jax:
the port imports nothing of the JAX package.  tests/test_torch_host_copies.py
holds the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Atmosphere:
    """Container of SI fields on the regular grid (atmosphere.jl:22-54)."""
    z: np.ndarray                    # (nz,) [m], ascending
    x: np.ndarray                    # (nx,) [m], ascending, equidistant
    y: np.ndarray                    # (ny,) [m], ascending, equidistant
    temperature: np.ndarray          # (nz, nx, ny) [K]
    electron_density: np.ndarray     # (nz, nx, ny) [m^-3]
    hydrogen_populations: np.ndarray  # (nz, nx, ny) [m^-3] (total H)
    velocity_z: np.ndarray           # (nz, nx, ny) [m/s]
    velocity_x: np.ndarray
    velocity_y: np.ndarray

    @property
    def shape(self):
        return self.temperature.shape

    @property
    def dx(self):
        return float(self.x[1] - self.x[0])

    @property
    def dy(self):
        return float(self.y[1] - self.y[0])

    def velocity_zxy(self):
        """Stacked velocities (..., 3) ordered (v_z, v_x, v_y)."""
        return np.stack(
            [self.velocity_z, self.velocity_x, self.velocity_y], axis=-1)

    def fields(self):
        return dict(
            temperature=self.temperature,
            electron_density=self.electron_density,
            hydrogen_populations=self.hydrogen_populations,
            velocity_z=self.velocity_z,
            velocity_x=self.velocity_x,
            velocity_y=self.velocity_y,
        )


def _ascending(axis_vals, arrays, dim):
    """Flip arrays along dim if axis is descending (atmosphere.jl:95-123)."""
    if axis_vals[0] > axis_vals[-1]:
        axis_vals = axis_vals[::-1].copy()
        arrays = [np.flip(a, axis=dim) for a in arrays]
    return axis_vals, arrays


def get_atmos(file_path, periodic=True, skip=1):
    """Load a Bifrost-style HDF5 atmosphere (atmosphere.jl:64-158).

    Expects datasets z, x, y, temperature, electron_density,
    hydrogen_populations (level axes are collapsed with [...,0,0] when 5-D),
    velocity_{z,x,y}; SI units on disk.
    """
    import h5py

    with h5py.File(file_path, "r") as f:
        z = np.asarray(f["z"][:]).squeeze()[::skip].astype(np.float64)
        x = np.asarray(f["x"][:]).squeeze()[::skip].astype(np.float64)
        y = np.asarray(f["y"][:]).squeeze()[::skip].astype(np.float64)
        sl = (slice(None, None, skip),) * 3
        vz = np.asarray(f["velocity_z"][sl], dtype=np.float64)
        vx = np.asarray(f["velocity_x"][sl], dtype=np.float64)
        vy = np.asarray(f["velocity_y"][sl], dtype=np.float64)
        T = np.asarray(f["temperature"][sl], dtype=np.float64)
        ne = np.asarray(f["electron_density"][sl], dtype=np.float64)
        nH = f["hydrogen_populations"]
        if nH.ndim == 5:
            nH = nH[sl + (0, 0)]
        else:
            nH = nH[sl]
        nH = np.asarray(nH, dtype=np.float64)

    arrays = [vz, vx, vy, T, ne, nH]
    z, arrays = _ascending(z, arrays, 0)
    x, arrays = _ascending(x, arrays, 1)
    y, arrays = _ascending(y, arrays, 2)
    vz, vx, vy, T, ne, nH = arrays

    if periodic:
        x = periodic_axis(x)
        y = periodic_axis(y)
        vz, vx, vy, T, ne, nH = (periodic_borders(a)
                                 for a in (vz, vx, vy, T, ne, nH))

    return Atmosphere(z=z, x=x, y=y, temperature=T, electron_density=ne,
                      hydrogen_populations=nH, velocity_z=vz,
                      velocity_x=vx, velocity_y=vy)


def periodic_axis(vec):
    """Extend a 1-D axis by one ghost step each side (atmosphere.jl:166-182)."""
    dl = vec[1] - vec[0]
    return np.concatenate([[vec[0] - dl], vec, [vec[-1] + dl]])


def periodic_borders(arr):
    """Add periodic ghost layers in x, y (dims 1, 2) (atmosphere.jl:191-214)."""
    out = np.empty((arr.shape[0], arr.shape[1] + 2, arr.shape[2] + 2),
                   dtype=arr.dtype)
    out[:, 1:-1, 1:-1] = arr
    out[:, 0, 1:-1] = arr[:, -1, :]
    out[:, -1, 1:-1] = arr[:, 0, :]
    out[:, 1:-1, -1] = arr[:, :, 0]
    out[:, 1:-1, 0] = arr[:, :, -1]
    out[:, 0, 0] = arr[:, -1, -1]
    out[:, 0, -1] = arr[:, -1, 0]
    out[:, -1, 0] = arr[:, 0, -1]
    out[:, -1, -1] = arr[:, 0, 0]
    return out


def periodic_pops(arr):
    """Ghost layers for (nz, nx, ny, nlevel) arrays (atmosphere.jl:241-264)."""
    out = np.empty((arr.shape[0], arr.shape[1] + 2, arr.shape[2] + 2,
                    arr.shape[3]), dtype=arr.dtype)
    for l in range(arr.shape[3]):
        out[..., l] = periodic_borders(arr[..., l])
    return out


def atmosphere_with_ghosts(atmos: Atmosphere) -> Atmosphere:
    """Apply periodic ghost layers to an existing atmosphere."""
    return Atmosphere(
        z=atmos.z, x=periodic_axis(atmos.x), y=periodic_axis(atmos.y),
        temperature=periodic_borders(atmos.temperature),
        electron_density=periodic_borders(atmos.electron_density),
        hydrogen_populations=periodic_borders(atmos.hydrogen_populations),
        velocity_z=periodic_borders(atmos.velocity_z),
        velocity_x=periodic_borders(atmos.velocity_x),
        velocity_y=periodic_borders(atmos.velocity_y),
    )


def searchlight_atmosphere(n=51):
    """Unit-cube vacuum atmosphere for the searchlight test.

    Mirrors compare_searchlight.jl:154-176: LinRange(0,1,n) axes, T = 1 K,
    all densities and velocities zero.
    """
    ax = np.linspace(0.0, 1.0, n)
    zero = np.zeros((n, n, n))
    return Atmosphere(z=ax, x=ax.copy(), y=ax.copy(),
                      temperature=np.ones((n, n, n)),
                      electron_density=zero.copy(),
                      hydrogen_populations=zero.copy(),
                      velocity_z=zero.copy(), velocity_x=zero.copy(),
                      velocity_y=zero.copy())


def synthetic_atmosphere(nz=32, nx=16, ny=16, seed=1998,
                         z_top=2.0e6, z_bottom=-0.1e6, horiz_extent=2.0e6,
                         perturb=0.15):
    """Smooth FAL-C-like solar stratification + sinusoidal perturbations.

    Hermetic stand-in for the Bifrost snapshot (SURVEY.md §4.5): an
    exponentially stratified chromosphere/photosphere with a temperature
    minimum, mild horizontal structure, and a smooth velocity field.
    """
    rng = np.random.default_rng(seed)
    z = np.linspace(z_bottom, z_top, nz)
    x = np.linspace(0.0, horiz_extent, nx)
    y = np.linspace(0.0, horiz_extent, ny)

    # Temperature: photosphere ~6500 K, minimum ~4200 K near 0.5 Mm,
    # chromospheric rise to ~10 kK at the top.
    zn = (z - z_bottom) / (z_top - z_bottom)
    T_strat = (6500.0 - 2300.0 * np.exp(-((zn - 0.28) / 0.18) ** 2)
               + 4500.0 * zn**3)
    # Densities: exponential with scale height ~0.35 of the box.
    nH_strat = 10 ** (23.0 - 6.0 * zn)
    ne_strat = 10 ** (19.5 - 4.0 * zn)

    kx = 2.0 * np.pi / horiz_extent
    X, Y = np.meshgrid(x, y, indexing="ij")
    phase1, phase2 = rng.uniform(0, 2 * np.pi, 2)
    horiz = (np.sin(kx * X + phase1) * np.cos(kx * Y + phase2))

    T = T_strat[:, None, None] * (1.0 + perturb * horiz[None])
    nH = nH_strat[:, None, None] * (1.0 - perturb * horiz[None])
    ne = ne_strat[:, None, None] * (1.0 - perturb * horiz[None])

    v_amp = 3.0e3  # m/s
    vz = v_amp * horiz[None] * np.sin(np.pi * zn)[:, None, None]
    vx = 0.5 * v_amp * np.cos(kx * Y)[None] * np.ones_like(T)
    vy = 0.5 * v_amp * np.sin(kx * X)[None] * np.ones_like(T)

    return Atmosphere(z=z, x=x, y=y, temperature=T, electron_density=ne,
                      hydrogen_populations=nH, velocity_z=vz,
                      velocity_x=vx, velocity_y=vy)
