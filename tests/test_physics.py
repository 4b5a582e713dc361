"""Physics helpers: reflection invariants, and the Fresnel factor matches the reference's scalar routine exactly (ref
tracer.py:32-61 semantics are pinned by the oracle; here we pin edge cases)."""

import numpy as np

import jax.numpy as jnp

from rfx import physics


def _rand_unit(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_reflect_involution_and_norm():
    d = jnp.asarray(_rand_unit(513, 4))
    n = jnp.asarray(_rand_unit(513, 5))
    r = physics.reflect(d, n)
    # reflection preserves length and is an involution
    assert bool(jnp.allclose(jnp.linalg.norm(r, axis=1), 1.0, atol=1e-5))
    assert bool(jnp.allclose(physics.reflect(r, n), d, atol=1e-5))
    # sign of n is irrelevant (ref kernel.py:96 ignores the sign output)
    assert bool(jnp.allclose(physics.reflect(d, -n), r, atol=1e-6))


def test_fresnel_reference_scalar_parity():
    """Match the reference formula evaluated in pure Python (ref tracer.py:34-61)."""
    import math

    def ref_bounce_amplitude(angle, n1=5.0, n2=1.0):
        if math.isnan(angle):
            return 0.0
        theta = (math.pi / 2) - (angle / 2)
        try:
            theta_i = math.asin(n2 * math.sin(theta) / n1)
        except ValueError:
            return 0.0
        denom = n2 * math.cos(theta_i) + n1 * math.cos(theta)
        if denom == 0:
            return 0.0
        amp = -(((n2 * math.cos(theta_i) - n1 * math.cos(theta)) / denom) ** 2)
        amp = max(amp, -1.0)
        return -amp

    angles = np.linspace(1e-3, np.pi - 1e-3, 64)
    want = np.array([ref_bounce_amplitude(a) for a in angles])
    got = np.asarray(physics.fresnel_bounce_amplitude(jnp.asarray(angles, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # range + NaN guard
    assert np.all((got >= 0.0) & (got <= 1.0))
    assert float(physics.fresnel_bounce_amplitude(jnp.float32(np.nan))) == 0.0
