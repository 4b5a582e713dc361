"""RF physics on device (JAX), differentiable.

The reference computes all of this on the host in a Python loop over received
paths (ref tracer.py:102-117) with a scalar Fresnel routine (ref
tracer.py:32-61). Here the same math runs vectorised on the device inside
the bounce scan, and is differentiable w.r.t. the refractive indices.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["reflect", "bend_angle", "fresnel_bounce_amplitude"]


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Specular reflection v - 2 (v.n) n (ref kernel.py:6-8). Invariant to the
    sign of n, so unoriented face normals are fine (SURVEY.md 2.2)."""
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def bend_angle(d_in: jnp.ndarray, d_out: jnp.ndarray) -> jnp.ndarray:
    """Angle between consecutive unit path segments (the reference derives it
    from stored path vertices, ref tracer.py:106-109; with specular bounces it
    is exactly the angle between incoming and outgoing directions)."""
    cosang = jnp.sum(d_in * d_out, axis=-1)
    # arccos'(+-1) is inf; clamp epsilon-inside so VJPs stay finite. The value
    # error at exact normal/grazing incidence is ~1e-3 rad, negligible through
    # the Fresnel factor (and the oracle tolerance).
    return jnp.arccos(jnp.clip(cosang, -1.0 + 1e-6, 1.0 - 1e-6))


def fresnel_bounce_amplitude(angle_between, n1=5.0, n2=1.0):
    """The reference's as-written s-polarised Fresnel power factor
    (ref tracer.py:34-61) — reproduced exactly, including the swapped-media
    convention and NaN->0 guards; see SURVEY.md 2.1. Returns values in [0, 1].

    Differentiable w.r.t. angle, n1 and n2 (the material parameters of the
    inverse solve).
    """
    theta = (jnp.pi / 2.0) - (angle_between / 2.0)
    sin_ratio = (n2 * jnp.sin(theta)) / n1
    # arcsin of |x|>1 would be NaN -> the reference maps NaN results to 0.
    valid = jnp.abs(sin_ratio) <= 1.0
    theta_i = jnp.arcsin(jnp.clip(sin_ratio, -1.0 + 1e-7, 1.0 - 1e-7))
    num = n2 * jnp.cos(theta_i) - n1 * jnp.cos(theta)
    denom = n2 * jnp.cos(theta_i) + n1 * jnp.cos(theta)
    amp = -((num / jnp.where(denom != 0.0, denom, 1.0)) ** 2)
    amp = jnp.maximum(amp, -1.0)
    out = -amp
    out = jnp.where(valid & (denom != 0.0) & ~jnp.isnan(angle_between), out, 0.0)
    return out
