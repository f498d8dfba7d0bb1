"""Range spectra's observable bounds in f32.

A bound often lands exactly on a grid point (n*end/n = 1.0, 0.5, ...). A
GPU's f32 division is not correctly rounded (it gave 0.99999994 for 1.0 on
an H100), so which grid points fall inside a range must not depend on the
last bit of a bound."""

import jax.numpy as jnp
import numpy as np
import pytest

from varlociraptor_tpu.ops import posterior
from varlociraptor_tpu.ops.grid import AFGrid

GRID = jnp.asarray(AFGrid.build(0.01, extra_points=(0.5, 0.25)).values)
N_OBS = jnp.arange(0.0, 200.0, dtype=jnp.float32)[:, None]  # [N, 1]
# (start, end, left exclusive, right exclusive): the tumor-normal scenario's
# range spectra and a few off-lattice ones
RANGES = [(0.0, 1.0, True, False), (0.0, 0.5, True, True), (0.5, 1.0, False, False),
          (0.25, 0.75, True, True), (0.1, 0.3, False, True)]


def _weights(start, end, lx, rx):
    args = [jnp.full((1, 1), v, jnp.float32) for v in (start, end)]
    args += [jnp.full((1, 1), v) for v in (lx, rx)]
    return np.asarray(posterior.range_weights(GRID, *args, N_OBS))


@pytest.mark.parametrize("rng", RANGES)
@pytest.mark.parametrize("direction", [1.0, -1.0])
def test_one_ulp_in_a_bound_moves_no_grid_point(monkeypatch, rng, direction):
    want = _weights(*rng)
    orig = posterior.observable_bounds

    def nudged(*a):
        amin, amax = orig(*a)
        # direction +1 narrows the range by one ulp at each end, -1 widens it
        return (jnp.nextafter(amin, amin + direction),
                jnp.nextafter(amax, amax - direction))

    monkeypatch.setattr(posterior, "observable_bounds", nudged)
    got = _weights(*rng)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=1e-5)


def test_bounds_on_the_lattice():
    """n*end lattice points: end=1.0 keeps 1.0 inside; a right-exclusive
    0.5 stops one read short of it; a left-exclusive 0 starts at 1/n."""
    n = jnp.asarray([20.0], jnp.float32)
    f = jnp.asarray
    amin, amax = posterior.observable_bounds(f(0.0), f(1.0), f(True), f(False), n)
    assert float(amin[0]) == pytest.approx(1 / 20) and float(amax[0]) == 1.0
    amin, amax = posterior.observable_bounds(f(0.0), f(0.5), f(True), f(True), n)
    assert float(amin[0]) == pytest.approx(1 / 20)
    assert float(amax[0]) == pytest.approx(9 / 20)
