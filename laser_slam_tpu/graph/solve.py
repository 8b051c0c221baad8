"""SE(2) pose-graph optimization: batched robust Gauss-Newton.

Batched JAX replacement for the reference's g2o + CHOLMOD backend
(``CMapGraph::optimizeGraph``, src/mapGraph/MapGraph.cpp:2362-2380, with
edge insertion at addEdgeToG2O 2382-2425). Design:

- the graph is fixed-shape arrays: ``poses [V, 3]``, edges
  ``(i [E], j [E], meas [E, 3], info [E, 3, 3], active [E])`` with an
  ``active`` mask for preallocated-but-unused slots (dynamic graph growth
  without dynamic shapes);
- residuals/Jacobians for **all** edges are computed batched; the normal
  system is assembled with ``segment_sum`` scatters into a dense
  ``[3V, 3V]`` matrix and solved densely on the device. The reference's
  submap hierarchy keeps V small (~N/10, MapGraph.cpp:725), so the dense
  solve is both exact and fast; past ``DENSE_SOLVER_MAX_V`` vertices the
  matrix-free block-Jacobi CG path (:func:`_cg_solve_normal`) takes over
  — O(E) per iteration, no dense factor;
- robustness: Huber reweighting per edge instead of g2o kernels, plus the
  caller-side consistency pruning in :mod:`.loop_closure`;
- gauge freedom fixed by anchoring vertex 0 (g2o's ``setFixed``).

Iteration stops on chi² stagnation like the reference (Δchi² < 1e-5,
optimizeGraph:2369-2378) but with a fixed iteration cap under
``lax.while_loop``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2

Array = jnp.ndarray

MAX_GN_ITERS = 20          # optimizeGraph's outer budget (MapGraph.cpp:2362)
CHI2_REL_TOL = 1e-5        # Δchi² stop (MapGraph.cpp:2369-2378)
# Robust kernel width on the Mahalanobis norm. Verified-and-consistency-
# pruned loops carry large (drift-sized) residuals that must still pull
# the graph closed; the reference applies no kernel at all on accepted
# loops (it prunes instead, MapGraph.cpp:169-223), so the kernel here
# only guards against gross outliers.
HUBER_DELTA = 5.0
DCS_PHI = 5.0              # DCS kernel scale for loop edges
# Gauge anchor and damping are chosen for float32 Cholesky: the anchor
# must dominate typical information (~50) without exploding the
# condition number, and damping floors the gauge-null eigenvalues.
ANCHOR_WEIGHT = 1e4
DAMPING = 1e-2


KERNEL_HUBER = 0
KERNEL_DCS = 1


class PoseGraph(NamedTuple):
    """Fixed-capacity SE(2) pose graph (all leaves device arrays)."""

    poses: Array     # [V, 3]
    v_active: Array  # [V] bool
    i: Array         # [E] int32 source vertex
    j: Array         # [E] int32 target vertex
    meas: Array      # [E, 3] measured relative pose (i → j)
    info: Array      # [E, 3, 3] information matrices
    e_active: Array  # [E] bool
    kernel: Array | None = None  # [E] int32: 0 = Huber, 1 = DCS (loops)


def edge_residuals(g: PoseGraph) -> Array:
    """``[E, 3]`` residuals ``log(meas⁻¹ ⊕ (xi⁻¹ ⊕ xj))``."""
    xi = g.poses[g.i]
    xj = g.poses[g.j]
    pred = se2.relative(xi, xj)
    d = se2.relative(g.meas, pred)
    return jnp.concatenate([d[:, :2], se2.normalize_angle(d[:, 2:3])], axis=-1)


def edge_jacobians(g: PoseGraph) -> tuple[Array, Array]:
    """Analytic Jacobians ``(Ji [E,3,3], Jj [E,3,3])`` of the residual wrt
    perturbations of ``xi`` and ``xj`` (right-multiplied local frame).

    Derived for the residual ``r = R(zθ)ᵀ (R(θi)ᵀ (tj - ti) - zt)`` style
    parametrization used above; matches numeric differentiation (tested).
    """
    xi = g.poses[g.i]
    xj = g.poses[g.j]
    thi = xi[:, 2]
    dz = xj[:, :2] - xi[:, :2]
    c, s = jnp.cos(thi), jnp.sin(thi)
    zc, zs = jnp.cos(g.meas[:, 2]), jnp.sin(g.meas[:, 2])

    # Rotation matrices R(θi)ᵀ and R(zθ)ᵀ.
    rit = jnp.stack(
        [jnp.stack([c, s], -1), jnp.stack([-s, c], -1)], axis=-2
    )                                                     # [E, 2, 2]
    rzt = jnp.stack(
        [jnp.stack([zc, zs], -1), jnp.stack([-zs, zc], -1)], axis=-2
    )
    rzt_rit = rzt @ rit                                   # [E, 2, 2]

    # d(R(θi)ᵀ dz)/dθi = R'(θi)ᵀ dz ; R'(θ)ᵀ = [[-s, c], [-c, -s]]
    dri = jnp.stack(
        [
            -s * dz[:, 0] + c * dz[:, 1],
            -c * dz[:, 0] - s * dz[:, 1],
        ],
        axis=-1,
    )                                                     # [E, 2]
    dth_i = (rzt @ dri[..., None])[..., 0]                # [E, 2]

    zero = jnp.zeros_like(thi)
    one = jnp.ones_like(thi)

    ji_top = jnp.concatenate([-rzt_rit, dth_i[..., None]], axis=-1)  # [E,2,3]
    ji_bot = jnp.stack([zero, zero, -one], axis=-1)[:, None, :]      # [E,1,3]
    Ji = jnp.concatenate([ji_top, ji_bot], axis=-2)

    jj_top = jnp.concatenate(
        [rzt_rit, jnp.zeros_like(dth_i)[..., None]], axis=-1
    )
    jj_bot = jnp.stack([zero, zero, one], axis=-1)[:, None, :]
    Jj = jnp.concatenate([jj_top, jj_bot], axis=-2)
    return Ji, Jj


def _edge_terms(g: PoseGraph) -> tuple[Array, Array, Array, Array, Array, Array]:
    """Per-edge Huber-weighted normal-equation blocks.

    Returns ``(Hii, Hjj, Hij, bi, bj, chi2)`` with shapes
    ``[E,3,3]×3, [E,3]×2, [E]``.
    """
    r = edge_residuals(g)                                  # [E, 3]
    # Inactive slots may hold garbage/NaN measurements (preallocated
    # capacity, failed matches); zero them before any arithmetic —
    # masking by multiplication alone would propagate NaN (0·NaN = NaN).
    r = jnp.where(g.e_active[:, None], jnp.nan_to_num(r), 0.0)
    Ji, Jj = edge_jacobians(g)
    Ji = jnp.nan_to_num(Ji)
    Jj = jnp.nan_to_num(Jj)

    chi = jnp.einsum("ei,eij,ej->e", r, g.info, r)
    # Huber: w = 1 for small chi, δ/√chi beyond.
    sqrt_chi = jnp.sqrt(jnp.maximum(chi, 1e-12))
    w_huber = jnp.where(sqrt_chi > HUBER_DELTA, HUBER_DELTA / sqrt_chi, 1.0)
    # Dynamic Covariance Scaling (Agarwal et al.): s = min(1, 2Φ/(Φ+χ²)),
    # weight s² — annihilates gross outliers (false loop closures the
    # acceptance gates missed) while leaving consistent edges untouched.
    phi = jnp.asarray(DCS_PHI, chi.dtype)
    s = jnp.minimum(1.0, 2.0 * phi / (phi + chi))
    w_dcs = s * s
    if g.kernel is None:
        w = w_huber
    else:
        w = jnp.where(g.kernel == KERNEL_DCS, w_dcs, w_huber)
    w = jnp.where(g.e_active, w, 0.0)

    wi = w[:, None, None] * g.info                         # [E, 3, 3]
    Hii = jnp.einsum("eki,ekl,elj->eij", Ji, wi, Ji)
    Hjj = jnp.einsum("eki,ekl,elj->eij", Jj, wi, Jj)
    Hij = jnp.einsum("eki,ekl,elj->eij", Ji, wi, Jj)
    bi = jnp.einsum("eki,ekl,el->ei", Ji, wi, r)
    bj = jnp.einsum("eki,ekl,el->ei", Jj, wi, r)
    return Hii, Hjj, Hij, bi, bj, w * chi


def assemble_normal_system(g: PoseGraph) -> tuple[Array, Array, Array]:
    """Dense ``[3V, 3V]`` H, ``[3V]`` b via segment-sum scatters, plus chi²."""
    v = g.poses.shape[0]
    Hii, Hjj, Hij, bi, bj, chi = _edge_terms(g)

    H = jnp.zeros((v, v, 3, 3), dtype=g.poses.dtype)
    H = H.at[g.i, g.i].add(Hii)
    H = H.at[g.j, g.j].add(Hjj)
    H = H.at[g.i, g.j].add(Hij)
    H = H.at[g.j, g.i].add(jnp.swapaxes(Hij, -1, -2))
    b = jnp.zeros((v, 3), dtype=g.poses.dtype)
    b = b.at[g.i].add(bi)
    b = b.at[g.j].add(bj)

    Hd = H.transpose(0, 2, 1, 3).reshape(3 * v, 3 * v)
    return Hd, b.reshape(3 * v), jnp.sum(chi)


def _solve_normal(g: PoseGraph, lam: Array) -> tuple[Array, Array]:
    """Solve the λ-damped normal equations; returns ``(dx [V,3], chi²)``."""
    v = g.poses.shape[0]
    Hd, b, chi2_w = assemble_normal_system(g)
    return _chol_solve_damped(g, Hd, b, lam), chi2_w


def _chol_solve_damped(g: PoseGraph, Hd: Array, b: Array, lam: Array) -> Array:
    v = g.poses.shape[0]
    # Gauge fix: anchor vertex 0 with a strong prior instead of deleting
    # rows (keeps shapes static; equivalent to g2o setFixed).
    anchor = jnp.zeros(3 * v, dtype=Hd.dtype).at[:3].set(ANCHOR_WEIGHT)
    # Inactive vertices get identity blocks so the solve stays full-rank.
    vmask = jnp.repeat(~g.v_active, 3)
    diag_fix = jnp.where(vmask, 1.0, 0.0) + anchor
    # Marquardt scaling: λ multiplies the diagonal, flooring at DAMPING.
    # The absolute floor also scales with the largest diagonal entry:
    # float32 assembly roundoff perturbs eigenvalues of the (PSD by
    # construction) H by O(ε·‖H‖), and a fixed floor below that makes the
    # damped matrix indefinite → NaN Cholesky on large graphs.
    diag_h = jnp.clip(jnp.diagonal(Hd), 1.0)
    floor = DAMPING + 1e-4 * jnp.max(diag_h)
    Hd = Hd + jnp.diag(diag_fix + lam * diag_h) + floor * jnp.eye(
        3 * v, dtype=Hd.dtype
    )
    # LU, not Cholesky: an f32 Cholesky NaN'd on the ~1e6+ condition
    # numbers a gauge-anchored normal matrix reaches (seen on real
    # intel-lab graphs; LU solves the same system), and at submap-graph
    # sizes the dense solve is small either way. Matmul precision is
    # pinned to full f32: the default may round operands (TF32 on GPUs).
    with jax.default_matmul_precision("highest"):
        dx = jnp.linalg.solve(Hd, -b).reshape(v, 3)
    return dx


def _cg_solve_normal(
    g: PoseGraph, lam: Array, cg_iters: int = 100, tol: float = 1e-6
) -> tuple[Array, Array]:
    """Matrix-free block-Jacobi-preconditioned CG on the damped normal
    equations — the large-V path. Never materializes H: the operator is
    two segment-scatter products over edge blocks ([E,3,3] einsums), so
    cost is O(E·9) per iteration and memory O(V+E) instead of the dense
    [3V,3V] factor (64 MB at V≈2.7k). Returns ``(dx [V,3], chi²)``."""
    v = g.poses.shape[0]
    dtype = g.poses.dtype
    Hii, Hjj, Hij, bi, bj, chi = _edge_terms(g)

    b = jnp.zeros((v, 3), dtype).at[g.i].add(bi).at[g.j].add(bj)

    # Diagonal terms: gauge anchor, inactive-vertex identity, damping.
    diag_blocks = (
        jnp.zeros((v, 3, 3), dtype).at[g.i].add(Hii).at[g.j].add(Hjj)
    )
    eye3 = jnp.eye(3, dtype=dtype)
    anchor = jnp.zeros((v,), dtype).at[0].set(ANCHOR_WEIGHT)
    inactive = (~g.v_active).astype(dtype)
    diag_h = jnp.clip(
        jnp.diagonal(diag_blocks, axis1=-2, axis2=-1), 1.0
    )                                                     # [V, 3]
    floor = DAMPING + 1e-4 * jnp.max(diag_h)
    extra = (
        (anchor + inactive)[:, None, None] * eye3
        + lam * diag_h[..., None] * eye3
        + floor * eye3
    )
    diag_all = diag_blocks + extra

    def hvp(x: Array) -> Array:                            # [V,3] → [V,3]
        xi = x[g.i]
        xj = x[g.j]
        yi = jnp.einsum("eij,ej->ei", Hij, xj)
        yj = jnp.einsum("eji,ej->ei", Hij, xi)             # Hijᵀ x_i
        y = jnp.zeros((v, 3), dtype).at[g.i].add(yi).at[g.j].add(yj)
        return y + jnp.einsum("vij,vj->vi", diag_all, x)

    # Block-Jacobi preconditioner: per-vertex 3×3 inverse.
    with jax.default_matmul_precision("highest"):
        minv = jnp.linalg.inv(diag_all)

        def precond(r):
            return jnp.einsum("vij,vj->vi", minv, r)

        rhs = -b
        x0 = jnp.zeros((v, 3), dtype)
        r0 = rhs - hvp(x0)
        z0 = precond(r0)
        p0 = z0
        rz0 = jnp.sum(r0 * z0)
        b2 = jnp.maximum(jnp.sum(rhs * rhs), 1e-30)

        def cond(s):
            _, r, _, _, k = s
            return (k < cg_iters) & (jnp.sum(r * r) > tol * tol * b2)

        def body(s):
            x, r, p, rz, k = s
            hp = hvp(p)
            alpha = rz / jnp.maximum(jnp.sum(p * hp), 1e-30)
            x = x + alpha * p
            r = r - alpha * hp
            z = precond(r)
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return (x, r, p, rz_new, k + 1)

        x, _, _, _, _ = jax.lax.while_loop(
            cond, body, (x0, r0, p0, rz0, 0)
        )
    return x, jnp.sum(chi)


def _apply(g: PoseGraph, dx: Array) -> Array:
    new_poses = jnp.concatenate(
        [
            g.poses[:, :2] + dx[:, :2],
            se2.normalize_angle(g.poses[:, 2:3] + dx[:, 2:3]),
        ],
        axis=-1,
    )
    return jnp.where(g.v_active[:, None], new_poses, g.poses)


def weighted_chi2(g: PoseGraph) -> Array:
    """Huber-weighted chi² (the LM acceptance objective)."""
    return _edge_terms(g)[-1].sum()


def gn_step(g: PoseGraph) -> tuple[PoseGraph, Array]:
    """One undamped Gauss-Newton step (kept for tests/small graphs)."""
    dx, chi = _solve_normal(g, jnp.asarray(0.0, g.poses.dtype))
    return g._replace(poses=_apply(g, dx)), chi


# Above this vertex count the dense [3V,3V] Cholesky factor (O(V²)
# memory, O(V³) time) loses to matrix-free CG; the submap hierarchy
# keeps typical graphs far below it.
DENSE_SOLVER_MAX_V = 1024


def optimize(
    g: PoseGraph,
    max_iters: int = MAX_GN_ITERS,
    solver: str = "auto",
) -> tuple[PoseGraph, Array]:
    """Levenberg-Marquardt with accept/reject and adaptive λ.

    Plain GN oscillates on loop closures with large rotational residuals
    (the exact workload here: drift-sized corrections); LM's step control
    is what g2o's Levenberg variant provides. Fully on-device; returns
    ``(graph, final weighted chi²)``.

    ``solver``: ``"chol"`` (dense LU solve of the normal matrix), ``"cg"``
    (matrix-free block-Jacobi CG for large V), or ``"auto"``.
    """
    dtype = g.poses.dtype
    if solver == "auto":
        solver = "cg" if g.poses.shape[0] > DENSE_SOLVER_MAX_V else "chol"
    solve = _cg_solve_normal if solver == "cg" else _solve_normal

    def cond(state):
        g_, lam, chi_cur, it, stall = state
        return (it < max_iters) & (stall < 3)

    def body(state):
        g_, lam, chi_cur, it, stall = state
        dx, _ = solve(g_, lam)
        cand = g_._replace(poses=_apply(g_, dx))
        chi_cand = weighted_chi2(cand)
        # A NaN solve (failed Cholesky) yields NaN poses whose residuals
        # are nan_to_num-zeroed — chi² == 0, a perfect score. Guard: a
        # candidate must be finite to be accepted.
        accept = (chi_cand < chi_cur) & jnp.all(jnp.isfinite(cand.poses))
        g_next = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), cand, g_
        )
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-6), lam * 5.0)
        chi_next = jnp.where(accept, chi_cand, chi_cur)
        improved = chi_cur - chi_next > CHI2_REL_TOL
        stall = jnp.where(improved, 0, stall + 1)
        return (g_next, lam, chi_next, it + 1, stall)

    chi0 = weighted_chi2(g)
    lam0 = jnp.asarray(1e-4, dtype)
    g_out, _, chi, _, _ = jax.lax.while_loop(
        cond, body, (g, lam0, chi0, 0, 0)
    )
    return g_out, chi


def chi2(g: PoseGraph) -> Array:
    r = edge_residuals(g)
    r = jnp.where(g.e_active[:, None], jnp.nan_to_num(r), 0.0)
    c = jnp.einsum("ei,eij,ej->e", r, g.info, r)
    return jnp.sum(jnp.where(g.e_active, c, 0.0))


# ---------------------------------------------------------------------------
# Linear initialization (LAGO-style) — 2D pose graphs are special: given
# relative-angle measurements the orientations are a *linear* problem in
# unit-circle embeddings, and given orientations the positions are linear
# too. Two small dense solves produce a near-global
# initialization that plain GN/LM cannot reach from drifted odometry
# (large coordinated rotations = the classic pose-graph local minimum).
# The reference has no equivalent — g2o is simply initialized from
# odometry and loop closures are applied incrementally, which sidesteps
# (but does not solve) the batch-initialization problem.
# ---------------------------------------------------------------------------


def _masked_w(g: PoseGraph, idx: int) -> Array:
    w = g.info[:, idx, idx]
    return jnp.where(g.e_active, w, 0.0)


def linear_initialize(g: PoseGraph) -> PoseGraph:
    """Rotation-then-translation linear initialization.

    Stage 1: embed each orientation as a point ``z_i`` on the plane and
    minimize ``Σ w‖z_j − R(δθ_e) z_i‖²`` (anchored ``z_0 = (1,0)``) — a
    linear system whose solution's ``atan2`` is a near-optimal set of
    absolute orientations regardless of 2π wraps.

    Stage 2: with orientations fixed, minimize
    ``Σ w‖t_j − t_i − R(θ_i) δt_e‖²`` — linear in the positions.
    """
    v = g.poses.shape[0]
    dtype = g.poses.dtype
    meas = jnp.where(g.e_active[:, None], jnp.nan_to_num(g.meas), 0.0)

    def laplacian_solve(rot_edges: Array, rhs_edges: Array, w: Array, anchor_val: Array):
        """Solve Σ w‖x_j − A_e x_i − c_e‖² for x ∈ R^{V×2}, x_0 anchored.

        ``rot_edges [E,2,2]``: A_e; ``rhs_edges [E,2]``: c_e.
        """
        H = jnp.zeros((v, v, 2, 2), dtype)
        eye2 = jnp.eye(2, dtype=dtype)
        AtA = jnp.einsum("eki,ekj->eij", rot_edges, rot_edges) * w[:, None, None]
        H = H.at[g.i, g.i].add(AtA)
        H = H.at[g.j, g.j].add(w[:, None, None] * eye2)
        cross = -rot_edges * w[:, None, None]            # (J_jᵀ W J_i) = -A w
        H = H.at[g.j, g.i].add(cross)
        H = H.at[g.i, g.j].add(jnp.swapaxes(cross, -1, -2))

        b = jnp.zeros((v, 2), dtype)
        # residual r = x_j - A x_i - c ; ∂r/∂x_i = -A, ∂r/∂x_j = I
        b = b.at[g.i].add(jnp.einsum("eki,ek->ei", rot_edges, rhs_edges) * w[:, None])
        b = b.at[g.j].add(-rhs_edges * w[:, None])

        # Anchor/regularization sized for f32: the gauge prior only has
        # to dominate typical edge information (~50), and the ridge only
        # to floor the near-null chain modes — a 1e4/1e-4 split pushes
        # the condition number past what f32 factorizations survive.
        lin_anchor = jnp.asarray(1e3, dtype)
        diag = jnp.zeros(2 * v, dtype).at[:2].set(lin_anchor)
        Hd = H.transpose(0, 2, 1, 3).reshape(2 * v, 2 * v)
        Hd = Hd + jnp.diag(diag) + 1e-3 * jnp.eye(2 * v, dtype=dtype)
        rhs = -b.reshape(-1) + (jnp.zeros((v, 2), dtype).at[0].set(
            anchor_val * lin_anchor
        )).reshape(-1)
        # LU at full f32 (an f32 Cholesky NaN'd at this conditioning).
        with jax.default_matmul_precision("highest"):
            return jnp.linalg.solve(Hd, rhs).reshape(v, 2)

    # Stage 1: orientations via unit-circle embedding, with one IRLS
    # (Cauchy) reweighting pass: a plain linear solve has no robustness,
    # and a handful of aliased false loops would bend every orientation;
    # the reweight pass cuts their influence by their first-pass
    # residual before the estimate anyone consumes is produced.
    dth = meas[:, 2]
    c, s = jnp.cos(dth), jnp.sin(dth)
    rot = jnp.stack(
        [jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], axis=-2
    )                                                   # [E, 2, 2]
    w_th = _masked_w(g, 2)
    zero_rhs = jnp.zeros((meas.shape[0], 2), dtype)
    e1 = jnp.asarray([1.0, 0.0], dtype)

    def theta_residual(z):
        zi = z[g.i] / jnp.maximum(
            jnp.linalg.norm(z[g.i], axis=-1, keepdims=True), 1e-6
        )
        zj = z[g.j] / jnp.maximum(
            jnp.linalg.norm(z[g.j], axis=-1, keepdims=True), 1e-6
        )
        pred = jnp.einsum("eij,ej->ei", rot, zi)
        return jnp.linalg.norm(zj - pred, axis=-1)      # chord distance

    z = laplacian_solve(rot, zero_rhs, w_th, e1)
    r1 = theta_residual(z)
    cau = jnp.asarray(0.5, dtype)                        # ~30° chord scale
    w_irls = 1.0 / (1.0 + (r1 / cau) ** 2)
    z = laplacian_solve(rot, zero_rhs, w_th * w_irls, e1)
    theta = jnp.arctan2(z[:, 1], z[:, 0])

    # Stage 2: positions, orientations fixed; reuse the robustness
    # weights (an edge with a wrong rotation has a wrong translation).
    ci, si = jnp.cos(theta[g.i]), jnp.sin(theta[g.i])
    rhs = jnp.stack(
        [
            ci * meas[:, 0] - si * meas[:, 1],
            si * meas[:, 0] + ci * meas[:, 1],
        ],
        axis=-1,
    )                                                   # R(θ_i) δt
    eyeE = jnp.tile(jnp.eye(2, dtype=dtype)[None], (meas.shape[0], 1, 1))
    w_t = 0.5 * (_masked_w(g, 0) + _masked_w(g, 1)) * w_irls
    t = laplacian_solve(eyeE, rhs, w_t, g.poses[0, :2])

    new_poses = jnp.concatenate([t, theta[:, None]], axis=-1)
    new_poses = jnp.where(g.v_active[:, None], new_poses, g.poses)
    return g._replace(poses=new_poses)


def optimize_with_init(
    g: PoseGraph, max_iters: int = MAX_GN_ITERS
) -> tuple[PoseGraph, Array]:
    """Linear initialization followed by LM polish, keeping whichever
    result scores better (the linear stage can only help if its
    assumptions hold — guard against pathological graphs)."""
    g_lin = linear_initialize(g)
    # Compare on the RAW chi² (no robust kernels): DCS scores a start
    # that leaves loop residuals huge as *good* (it annihilates exactly
    # the unexplained edges), so a weighted comparison would reject
    # every loop-closing initialization in favor of drifted odometry —
    # the precise failure mode this function exists to avoid.
    # NaN poses would zero out through nan_to_num in _edge_terms and
    # score a perfect chi² — a failed linear solve must never win.
    better = (chi2(g_lin) < chi2(g)) & jnp.all(jnp.isfinite(g_lin.poses))
    g_start = jax.tree.map(lambda a, b: jnp.where(better, a, b), g_lin, g)
    return optimize(g_start, max_iters)
