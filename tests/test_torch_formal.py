"""voronoirt_tpu_torch formal-solution weights against the JAX package.

The same dtau grids, crossing every branch (the small-dtau Taylor guard
below 5e-4, the generic branch, the large-dtau limit above 50), go
through both packages.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from voronoirt_tpu.solvers import formal as jf
from voronoirt_tpu_torch.solvers import formal as tf

DTAU = np.concatenate([
    [0.0, 1e-9, 1e-6, 1e-4, 4.9e-4, 5e-4, 5.2e-4],
    np.logspace(-3, np.log10(45.0), 40),
    [49.9, 50.0, 50.1, 80.0, 1e3, 1e6]])

CASES = [(np.float64, 1e-14), (np.float32, 1e-6)]


def _both(fn_name, *arrays):
    want = getattr(jf, fn_name)(*(jnp.asarray(a) for a in arrays))
    got = getattr(tf, fn_name)(*(torch.from_numpy(a) for a in arrays))
    return got, want


@pytest.mark.parametrize("dtype,rtol", CASES)
def test_linear_weights(dtype, rtol):
    got, want = _both("linear_weights", DTAU.astype(dtype))
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("dtype,rtol,atol",
                         [(np.float64, 1e-14, 1e-12), (np.float32, 1e-6, 0)])
def test_bezier_weights(dtype, rtol, atol):
    """The Bezier mid branch starts at dtau = 0.05, where J1 and J2
    cancel about four digits: a one-ulp difference between the two
    libraries' exp grows to ~2e-13 there, hence the float64 atol on
    these O(1e-2..1) weights."""
    dtau = np.concatenate([DTAU, [0.049, 0.05, 0.051]]).astype(dtype)
    got, want = _both("bezier_weights", dtau)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype,rtol", CASES)
def test_bezier_control_and_trapezoidal(dtype, rtol):
    rng = np.random.default_rng(5)
    n = 200
    S_uu, S_up, S_c = (rng.uniform(0.1, 1.0, n).astype(dtype)
                       for _ in range(3))
    dtau_uu = (10.0 ** rng.uniform(-4, 2, n)).astype(dtype)
    dtau = (10.0 ** rng.uniform(-4, 2, n)).astype(dtype)
    for first in (0.0, 1.0):
        want = jf.bezier_control(*(jnp.asarray(a) for a in
                                   (S_uu, S_up, S_c, dtau_uu, dtau)), first)
        got = tf.bezier_control(*(torch.from_numpy(a) for a in
                                  (S_uu, S_up, S_c, dtau_uu, dtau)), first)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=0)
    got, want = _both("trapezoidal", dtau, S_up, S_c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=0)
