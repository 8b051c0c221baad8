"""Covariance (EKF) and UdU-factorized Kalman filtering.

JAX equivalents of the remaining Bayes++ schemes vendored by the
reference (src/sensorFusion/): the covariance filter
(``Covariance_scheme``, covFlt.cpp), and the UdU-factorized square-root
filter (``UD_scheme`` built on the UdU utilities in UdU.cpp — Bierman
sequential observe, Thornton/MWG-S predict). The reference only
instantiates the unscented and SIR schemes (see :mod:`.ukf` and
:mod:`..localization.particle_filter`), but the full filter family is
part of its library surface, so it is provided here with the same
predict/observe decomposition — as pure jit/vmap-friendly functions.

Design notes (accelerator-first, not a port):

- No uBLAS-style triangular bookkeeping: the covariance filter keeps a
  dense symmetric ``[D, D]`` matrix and uses the Joseph form, which XLA
  fuses into a handful of small matmuls.
- The UdU filter stores the factors ``U`` (unit upper-triangular) and
  ``d`` (diagonal) explicitly. Factorization, Bierman rank-1 observe
  and the MWG-S predict are expressed with ``lax.fori_loop`` over the
  (small, static) state dimension so everything stays traceable; for
  the tiny SE(2)-scale states used here the whole update is a few
  microseconds on-device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

Array = jnp.ndarray


# ---------------------------------------------------------------------------
# Covariance (extended Kalman) filter — Bayes++ covFlt.cpp analog
# ---------------------------------------------------------------------------


class KalmanState(NamedTuple):
    mean: Array  # [D]
    cov: Array   # [D, D]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]


def init(mean: Array, cov: Array | float) -> KalmanState:
    mean = jnp.asarray(mean, jnp.float32)
    d = mean.shape[0]
    if jnp.ndim(cov) == 0:
        cov = jnp.eye(d) * cov
    return KalmanState(mean=mean, cov=jnp.asarray(cov, jnp.float32))


def predict_linear(state: KalmanState, F: Array, q: Array | float) -> KalmanState:
    """Linear(ized) predict ``x <- F x``, ``P <- F P Fᵀ + Q``."""
    d = state.dim
    if jnp.ndim(q) == 0:
        q = jnp.eye(d) * q
    return KalmanState(F @ state.mean, F @ state.cov @ F.T + jnp.asarray(q))


def predict(
    state: KalmanState,
    f: Callable[[Array], Array],
    q: Array | float,
) -> KalmanState:
    """Nonlinear predict: propagate the mean through ``f`` and linearize
    with ``jax.jacfwd`` (the covariance filter's first-order propagation,
    vs the UKF's sigma points)."""
    F = jax.jacfwd(f)(state.mean)
    d = state.dim
    if jnp.ndim(q) == 0:
        q = jnp.eye(d) * q
    return KalmanState(f(state.mean), F @ state.cov @ F.T + jnp.asarray(q))


def update_linear(
    state: KalmanState, H: Array, innov: Array, r: Array | float
) -> KalmanState:
    """Joseph-form linear observe (numerically symmetric)."""
    k = H.shape[0]
    if jnp.ndim(r) == 0:
        r = jnp.eye(k) * r
    R = jnp.asarray(r)
    S = H @ state.cov @ H.T + R
    K = jnp.linalg.solve(S, H @ state.cov).T
    mean = state.mean + K @ innov
    ikh = jnp.eye(state.dim) - K @ H
    cov = ikh @ state.cov @ ikh.T + K @ R @ K.T
    return KalmanState(mean, cov)


def update(
    state: KalmanState,
    h: Callable[[Array], Array],
    z: Array,
    r: Array | float,
) -> KalmanState:
    """Nonlinear observe, linearized at the current mean."""
    H = jnp.atleast_2d(jax.jacfwd(h)(state.mean))
    innov = jnp.atleast_1d(z - h(state.mean))
    return update_linear(state, H, innov, r)


# ---------------------------------------------------------------------------
# UdU factorization utilities — Bayes++ UdU.cpp analog
# ---------------------------------------------------------------------------


class UdState(NamedTuple):
    """Square-root filter state: ``P = U diag(d) Uᵀ`` with ``U`` unit
    upper-triangular."""

    mean: Array  # [D]
    U: Array     # [D, D] unit upper-triangular
    d: Array     # [D]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def cov(self) -> Array:
        return (self.U * self.d[None, :]) @ self.U.T


def udu_factorize(P: Array) -> tuple[Array, Array]:
    """Factor a symmetric PSD matrix as ``P = U diag(d) Uᵀ``
    (upper-triangular variant of Cholesky; UdU.cpp ``UdUfactor``).

    Runs a reverse ``fori_loop`` over the static dimension; for the
    small filter states involved this compiles to straight-line code.
    """
    n = P.shape[0]
    U = jnp.zeros_like(P)
    d = jnp.zeros(n, P.dtype)

    def body(k, carry):
        P_, U_, d_ = carry
        j = n - 1 - k
        dj = P_[j, j]
        d_ = d_.at[j].set(dj)
        safe = jnp.where(dj > 0, dj, 1.0)
        col = jnp.where(jnp.arange(n) < j, P_[:, j] / safe, 0.0)
        col = jnp.where(dj > 0, col, jnp.zeros(n, P.dtype))
        U_ = U_.at[:, j].set(col.at[j].set(1.0))
        # rank-1 downdate of the leading block
        P_ = P_ - dj * jnp.outer(col, col)
        return P_, U_, d_

    _, U, d = lax.fori_loop(0, n, body, (P, U, d))
    return U, d


def ud_init(mean: Array, cov: Array | float) -> UdState:
    mean = jnp.asarray(mean, jnp.float32)
    n = mean.shape[0]
    if jnp.ndim(cov) == 0:
        cov = jnp.eye(n) * cov
    U, d = udu_factorize(jnp.asarray(cov, jnp.float32))
    return UdState(mean, U, d)


def bierman_update(
    state: UdState, h_row: Array, innov: Array, r_scalar: Array | float
) -> UdState:
    """Bierman's rank-1 scalar observe on the U-d factors
    (UdU.cpp ``UdUrcond``/observe path). ``h_row`` is the [D] observation
    row, ``innov`` the scalar innovation, ``r_scalar`` its variance.

    Never forms the covariance — the factors stay exact, which is the
    point of the square-root filter (robust to ill-conditioning that
    makes the plain covariance filter lose positive-definiteness).
    """
    n = state.dim
    r = jnp.asarray(r_scalar, state.d.dtype)
    f = state.U.T @ h_row            # f = Uᵀ h
    g = state.d * f                  # g = D f
    alpha0 = r

    def body(j, carry):
        U, d, g_, alpha, b = carry
        beta = alpha + f[j] * g_[j]
        d = d.at[j].multiply(alpha / jnp.where(beta > 0, beta, 1.0))
        p = -f[j] / jnp.where(alpha > 0, alpha, 1.0)
        # column update: U[:, j] += p * b ; b += g[j] * U_old[:, j]
        col = U[:, j]
        U = U.at[:, j].set(col + p * b)
        b = b + g_[j] * col
        return U, d, g_, beta, b

    U, d, _, alpha, b = lax.fori_loop(
        0, n, body, (state.U, state.d, g, alpha0, jnp.zeros(n, state.d.dtype))
    )
    gain = b / jnp.where(alpha > 0, alpha, 1.0)
    mean = state.mean + gain * innov
    return UdState(mean, U, d)


def thornton_predict(
    state: UdState, F: Array, q_diag: Array
) -> UdState:
    """Modified weighted Gram-Schmidt (Thornton) time update:
    propagate the factors through ``x <- F x`` with diagonal process
    noise ``Q = diag(q_diag)`` (UdU.cpp predict path).

    Builds ``W = [F U | I]`` with weights ``[d | q]`` and re-orthogonalizes
    into fresh U-d factors.
    """
    n = state.dim
    W = jnp.concatenate([F @ state.U, jnp.eye(n, dtype=state.U.dtype)], axis=1)
    w = jnp.concatenate([state.d, jnp.asarray(q_diag, state.d.dtype)])

    U = jnp.eye(n, dtype=state.U.dtype)
    d = jnp.zeros(n, state.d.dtype)

    def body(k, carry):
        W_, U_, d_ = carry
        j = n - 1 - k
        row = W_[j]
        dj = jnp.sum(w * row * row)
        d_ = d_.at[j].set(dj)
        safe = jnp.where(dj > 0, dj, 1.0)
        proj = W_ @ (w * row) / safe            # [n] projections of each row
        proj = jnp.where(jnp.arange(n) < j, proj, 0.0)
        U_ = U_.at[:, j].set(proj.at[j].set(1.0))
        W_ = W_ - proj[:, None] * row[None, :]
        return W_, U_, d_

    _, U, d = lax.fori_loop(0, n, body, (W, U, d))
    return UdState(F @ state.mean, U, d)


def ud_update(
    state: UdState, H: Array, innov: Array, r_diag: Array
) -> UdState:
    """Vector observe as a sequence of Bierman scalar updates (valid for
    diagonal R; decorrelate first otherwise)."""
    H = jnp.atleast_2d(H)
    innov = jnp.atleast_1d(innov)
    r_diag = jnp.atleast_1d(jnp.asarray(r_diag))

    def body(i, st):
        # re-linearized innovation for sequential scalars: fold in the
        # state shift from previous rows
        shift = H[i] @ (st.mean - state.mean)
        return bierman_update(st, H[i], innov[i] - shift, r_diag[i])

    return lax.fori_loop(0, H.shape[0], body, state)
