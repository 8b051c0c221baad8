"""Batched SE(2) algebra.

Replaces the reference's ``OrientedPoint2D`` pointwise pose algebra
(reference: src/zhpsm/point.h:57-79 ``oplus``/``ominus``) with pure,
batched ``jax.numpy`` functions over ``[..., 3]`` arrays ``(x, y, theta)``.

Conventions
-----------
- Poses are ``(x, y, theta)`` in **meters / radians** (the reference mixes
  cm for PSM and m for the graph; we standardize on meters).
- All functions broadcast over leading batch dimensions and are safe to
  ``vmap`` / ``jit`` / differentiate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def normalize_angle(a: Array) -> Array:
    """Wrap angles to ``[-pi, pi)``.

    Branch-free equivalent of the reference's ``norm_a``
    (src/zhpsm/ZHPolar_Match.h:76-87).
    """
    return jnp.mod(a + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def identity(batch_shape: tuple = (), dtype=jnp.float32) -> Array:
    """The identity pose, optionally batched."""
    return jnp.zeros(batch_shape + (3,), dtype=dtype)


def compose(a: Array, b: Array) -> Array:
    """Pose composition ``a ⊕ b``: express pose ``b`` (given in ``a``'s
    frame) in the world frame. Reference: ``OrientedPoint2D::oplus``
    (src/zhpsm/point.h:62-70)."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = jnp.cos(ath), jnp.sin(ath)
    return jnp.stack(
        [
            ax + c * bx - s * by,
            ay + s * bx + c * by,
            normalize_angle(ath + bth),
        ],
        axis=-1,
    )


def inverse(a: Array) -> Array:
    """Pose inverse: ``inverse(a) ⊕ a == identity``."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    c, s = jnp.cos(ath), jnp.sin(ath)
    return jnp.stack(
        [
            -(c * ax + s * ay),
            s * ax - c * ay,
            normalize_angle(-ath),
        ],
        axis=-1,
    )


def relative(a: Array, b: Array) -> Array:
    """Relative pose ``a ⊖ b``: express world pose ``b`` in ``a``'s frame,
    i.e. ``compose(a, relative(a, b)) == b``. Reference:
    ``OrientedPoint2D::ominus`` (src/zhpsm/point.h:71-79)."""
    return compose(inverse(a), b)


def transform_points(pose: Array, pts: Array) -> Array:
    """Rigidly transform points ``[..., N, 2]`` by ``pose [..., 3]``."""
    x, y, th = pose[..., 0:1], pose[..., 1:2], pose[..., 2:3]
    c, s = jnp.cos(th), jnp.sin(th)
    px, py = pts[..., 0], pts[..., 1]
    return jnp.stack([c * px - s * py + x, s * px + c * py + y], axis=-1)


def rotation_matrix(theta: Array) -> Array:
    """``[..., 2, 2]`` rotation matrices from angles."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    row0 = jnp.stack([c, -s], axis=-1)
    row1 = jnp.stack([s, c], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def exp(tangent: Array) -> Array:
    """SE(2) exponential map from ``(vx, vy, omega)`` twists.

    Uses the closed-form V-matrix; Taylor-stable near ``omega == 0``.
    """
    vx, vy, w = tangent[..., 0], tangent[..., 1], tangent[..., 2]
    small = jnp.abs(w) < 1e-6
    # sin(w)/w and (1-cos(w))/w with stable small-angle limits
    w_safe = jnp.where(small, 1.0, w)
    a = jnp.where(small, 1.0 - w * w / 6.0, jnp.sin(w_safe) / w_safe)
    b = jnp.where(small, w / 2.0, (1.0 - jnp.cos(w_safe)) / w_safe)
    return jnp.stack(
        [a * vx - b * vy, b * vx + a * vy, normalize_angle(w)], axis=-1
    )


def log(pose: Array) -> Array:
    """SE(2) logarithm map (inverse of :func:`exp`)."""
    x, y, w = pose[..., 0], pose[..., 1], normalize_angle(pose[..., 2])
    small = jnp.abs(w) < 1e-6
    w_safe = jnp.where(small, 1.0, w)
    a = jnp.where(small, 1.0 - w * w / 6.0, jnp.sin(w_safe) / w_safe)
    b = jnp.where(small, w / 2.0, (1.0 - jnp.cos(w_safe)) / w_safe)
    det = a * a + b * b
    vx = (a * x + b * y) / det
    vy = (-b * x + a * y) / det
    return jnp.stack([vx, vy, w], axis=-1)


def chain(rel_poses: Array, init: Array | None = None) -> Array:
    """Integrate a ``[T, 3]`` sequence of relative poses into absolute
    poses ``[T, 3]`` with an associative scan (O(log T) depth).

    ``out[t] = init ⊕ rel[0] ⊕ rel[1] ⊕ ... ⊕ rel[t]``.
    """

    def op(a, b):
        return compose(a, b)

    out = jax.lax.associative_scan(op, rel_poses, axis=0)
    if init is not None:
        out = compose(init, out)
    return out


# -- NumPy mirrors ---------------------------------------------------------
# Host-side orchestration (bank bookkeeping, drift estimation, coverage)
# runs on small arrays every backend round; routing those through jnp
# costs a device dispatch plus a synchronous transfer and fetch per call.
# These mirrors keep the math on the host.

def np_normalize_angle(a):
    """NumPy mirror of :func:`normalize_angle`."""
    import numpy as np

    return np.mod(a + np.pi, 2.0 * np.pi) - np.pi


def np_relative(a, b):
    """NumPy mirror of :func:`relative`: pose of ``b`` in ``a``'s frame."""
    import numpy as np

    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = np.cos(ath), np.sin(ath)
    dx, dy = bx - ax, by - ay
    return np.stack(
        [
            c * dx + s * dy,
            -s * dx + c * dy,
            np_normalize_angle(bth - ath),
        ],
        axis=-1,
    )


def np_compose(a, b):
    """NumPy mirror of :func:`compose`."""
    import numpy as np

    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = np.cos(ath), np.sin(ath)
    return np.stack(
        [
            ax + c * bx - s * by,
            ay + s * bx + c * by,
            np_normalize_angle(ath + bth),
        ],
        axis=-1,
    )


def np_inverse(a):
    """NumPy mirror of :func:`inverse`."""
    import numpy as np

    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    c, s = np.cos(ath), np.sin(ath)
    return np.stack(
        [
            -(c * ax + s * ay),
            s * ax - c * ay,
            np_normalize_angle(-ath),
        ],
        axis=-1,
    )
