"""Offline study of the NS pressure-Schur complement preconditioners.

Forms the exact coupled Jacobian blocks of the (Boussinesq) NS system in the
Stokes limit (or with a mild wind) — the same masked rows as
``NavierStokesSolver``'s ``dres`` (velocity Dirichlet identity rows,
artificial ``∂ₙp=0`` stiffness rows, pressure pin; reference
NavierStokes_Solver.py:114-119, :176-212) — eliminates the velocity block
exactly (sparse LU, offline only), and measures how candidate Schur-block
preconditioners condition the pressure system across resolutions.

Motivation (round 2): the diagonal-GLL-mass Schur preconditioner (the
reference's, :208-212) degrades from ~20 to ~3000 GMRES iterations between
P=4 8x8 and p16 64x64.  Candidate mechanisms tested here:

* **boundary-row scaling** — the boundary rows of S are *exactly* the
  pressure-stiffness rows ``K[mb, :]`` (the divergence block B has zero rows
  there), and diagonally-scaled Laplacian rows condition like h⁻²: candidate
  ``mass+bb`` eliminates the (static!) boundary block exactly;
* **equal-order inf-sup decay** — spurious pressure modes make S singular in
  a resolution-dependent way: candidate ``bfbt`` (least-squares commutator)
  and ``diagS`` (exact |diag(S)|) would both degrade if this dominated.

Usage:  python study/schur_spectrum.py [P Ne [P Ne ...]] [--wind]
            [--lid RE] [--cands name1,name2,...]
        --lid RE: strong O(1) recirculating wind at Reynolds RE
        (the convection-dominated regime; candidates incl. 'pcd',
        'pcd_rev', 'bfbt' — bfbt builds dense (N,N), small grids only)
"""
import sys
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from sem_jax.mesh import Grid2D


def build_blocks(grid: Grid2D, Re=1e3, u=None, v=None):
    """Sparse blocks of the coupled Jacobian with the solver's masks."""
    N = grid.N
    m1x, m1y = grid.m1x, grid.m1y
    Dx = sp.kron(sp.csr_matrix(grid.K1x), sp.diags(m1y))
    Dy = sp.kron(sp.diags(m1x), sp.csr_matrix(grid.K1y))
    K = (Dx + Dy).tocsr()
    Gx = sp.kron(sp.csr_matrix(grid.G1x), sp.diags(m1y)).tocsr()
    Gy = sp.kron(sp.diags(m1x), sp.csr_matrix(grid.G1y)).tocsr()

    mb = grid.boundary_mask
    pin = np.zeros(N, dtype=bool)
    pin[N // 2] = True

    Sys = K.copy()
    if u is not None:
        Sys = Sys + Re * (sp.diags(u) @ Gx + sp.diags(v) @ Gy)

    def zero_rows(A, mask):
        A = A.tolil(copy=True)
        A[np.where(mask)[0], :] = 0.0
        return A.tocsr()

    def identity_rows(A, mask):
        A = zero_rows(A, mask).tolil()
        idx = np.where(mask)[0]
        A[idx, idx] = 1.0
        return A.tocsr()

    # velocity block (2N x 2N) with Dirichlet identity rows
    Z = sp.csr_matrix((N, N))
    if u is not None:
        jxx = sp.diags(Re * np.asarray(Gx @ u))
        jxy = sp.diags(Re * np.asarray(Gy @ u))
        jyx = sp.diags(Re * np.asarray(Gx @ v))
        jyy = sp.diags(Re * np.asarray(Gy @ v))
    else:
        jxx = jxy = jyx = jyy = Z
    A = sp.bmat([[identity_rows(Sys + jxx, mb), zero_rows(jxy, mb)],
                 [zero_rows(jyx, mb), identity_rows(Sys + jyy, mb)]]).tocsr()
    # gradient block (2N x N): zero rows on Dirichlet nodes
    G = sp.vstack([zero_rows(Gx, mb), zero_rows(Gy, mb)]).tocsr()
    # divergence block (N x 2N): zero rows on mb | pin
    B = sp.hstack([zero_rows(Gx, mb | pin), zero_rows(Gy, mb | pin)]).tocsr()
    # pressure block: K rows on mb, identity on pin
    C = identity_rows(zero_rows(K, ~mb), pin).tocsr()
    return A, G, B, C, K, mb, pin


def gmres_count(S_mv, n, Minv_apply, rtol=1e-10, maxiter=3000, restart=200):
    """Preconditioned GMRES iteration count on S dp = b.

    The RHS is made *consistent* (b = S x_true): the equal-order PN-PN
    discretization carries (near-)spurious pressure modes, so a random b has
    components outside range(S) that no solver can remove — while the
    solver's actual Schur RHSs are residuals, hence consistent (this is why
    the reference's Schur GMRES converges at all,
    reference NavierStokes_Solver.py:222-226)."""
    b = S_mv(np.random.default_rng(0).standard_normal(n))
    it = {"n": 0}

    def cb(_):
        it["n"] += 1

    Mop = spla.LinearOperator((n, n), matvec=Minv_apply)
    Sop = spla.LinearOperator((n, n), matvec=S_mv)
    x, info = spla.gmres(Sop, b, M=Mop, rtol=rtol, atol=0.0,
                         restart=restart, maxiter=max(1, maxiter // restart),
                         callback=cb, callback_type="pr_norm")
    res = np.linalg.norm(b - S_mv(x)) / np.linalg.norm(b)
    return it["n"], res


def run_config(P, Ne, Re=1e3, with_wind=False, lid_re=None,
               candidates=None):
    grid = Grid2D(P, Ne, Ne, 1.0, 1.0)
    N = grid.N
    u = v = None
    if lid_re is not None:
        # strong O(1) recirculating wind at lid-cavity Reynolds number —
        # the convection-dominated regime where the f32 mixed path stalls
        Re = float(lid_re)
        x, y = grid.points
        u = np.sin(np.pi * x) ** 2 * np.sin(2 * np.pi * y)
        v = -np.sin(2 * np.pi * x) * np.sin(np.pi * y) ** 2
    elif with_wind:
        # Boussinesq-cavity velocity magnitude (u_max·RePr ≈ 3.65 ⇒ ~5e-3)
        pts = grid.points
        u = 0.005 * np.sin(np.pi * pts[0]) * np.cos(np.pi * pts[1])
        v = -0.005 * np.cos(np.pi * pts[0]) * np.sin(np.pi * pts[1])
    A, G, B, C, K, mb, pin = build_blocks(grid, Re=Re, u=u, v=v)
    lu = spla.splu(A.tocsc())

    def S_mv(dp):
        return C @ dp - B @ lu.solve(np.asarray(G @ dp))

    md = grid.mass_diag
    sd = grid.stiff_diag
    ib = np.where(mb)[0]

    # --- candidate Schur preconditioners ---------------------------------
    def mass_inv(r):
        dp = r / md
        dp = np.where(mb, r / sd, dp)
        dp = np.where(pin, r, dp)
        return dp

    # exact boundary-block elimination: interior rows by inverse mass, then
    # the (static) boundary block K_bb dp_b = r_b - K_bi dp_i exactly
    K_bb = K[np.ix_(ib, ib)].toarray()
    K_bb_inv = np.linalg.inv(K_bb)

    def mass_bb_inv(r):
        dp = r / md
        dp = np.where(pin, r, dp)
        dp_b = K_bb_inv @ (r[ib] - (K[ib] @ np.where(mb, 0.0, dp)))
        dp = dp.copy()
        dp[ib] = dp_b
        return np.where(pin, r, dp)

    # BFBt / least-squares commutator
    def make_bfbt():
        Minv2 = sp.diags(np.concatenate([1.0 / md, 1.0 / md]))
        BMG = (B @ Minv2 @ G).toarray()
        BMAMG = (B @ Minv2 @ A @ Minv2 @ G).toarray()
        BMG_pinv = np.linalg.pinv(BMG, rcond=1e-10)

        def bfbt_inv(r):
            return BMG_pinv @ (BMAMG @ (BMG_pinv @ r))
        return bfbt_inv

    # exact |diag(S)| scaling (tests whether pure row scaling is the issue)
    def make_diagS():
        dS = np.array([S_mv(e)[i] for i, e in enumerate(np.eye(N))]) \
            if N <= 1200 else None
        if dS is None:
            return None
        dS = np.abs(dS) + 1e-300

        def diag_inv(r):
            return r / dS
        return diag_inv

    # --- tensor-structured candidates -----------------------------------
    # The consistent pressure Poisson E = B M⁻¹ G factorizes on this grid:
    # E = Ex ⊗ diag(m1y) + diag(m1x) ⊗ Ey with Ex = G1xᵀ m1x⁻¹ G1x — so its
    # (pseudo-)inverse is an FDM apply (4 dense matmuls), and E's near-null
    # tail *matches* S's near-spurious pressure modes (both come from G).
    def _e_pencil(G1, m1):
        import scipy.linalg
        Ex = G1.T @ np.diag(1.0 / m1) @ G1
        s = 1.0 / np.sqrt(m1)
        A1 = (Ex * s[:, None]) * s[None, :]
        A1 = 0.5 * (A1 + A1.T)
        lam, Q = scipy.linalg.eigh(A1)
        Z = s[:, None] * Q
        return lam, Z

    def _k_rayleigh(K1, Z):
        """Per-mode Rayleigh quotients of the 1D stiffness in the E-basis."""
        return np.einsum("ij,ik,kj->j", Z, K1, Z)

    def make_tensor(kind):
        ex, Zx = _e_pencil(grid.G1x, m1x_v)
        ey, Zy = _e_pencil(grid.G1y, m1y_v)
        esum = ex[:, None] + ey[None, :]
        if kind == "einv":
            scale = np.max(np.abs(esum))
            ginv = np.where(np.abs(esum) > 1e-12 * scale, 1.0 / esum, 0.0)
        else:  # 'specS': Ŝ ≈ E / K mode-by-mode (S ~ B K⁻¹ G vs E = B M⁻¹ G)
            lx = _k_rayleigh(grid.K1x, Zx)
            ly = _k_rayleigh(grid.K1y, Zy)
            ksum = lx[:, None] + ly[None, :]
            scale = np.max(np.abs(esum))
            ginv = np.where(np.abs(esum) > 1e-14 * scale, ksum / esum, 0.0)
        Ngx, Ngy = grid.Ngx, grid.Ngy

        def apply_(r):
            # interior rows through the tensor solve; boundary rows by
            # stiffness-Jacobi; pin identity (as the solver's pc does)
            r_int = np.where(mb | pin, 0.0, r).reshape(Ngx, Ngy)
            W = Zx.T @ r_int @ Zy
            dp = (Zx @ (ginv * W) @ Zy.T).reshape(-1)
            dp = np.where(mb, r / sd, dp)
            return np.where(pin, r, dp)
        return apply_

    m1x_v, m1y_v = grid.m1x, grid.m1y

    def make_specs_bb():
        base = make_tensor("specS")

        def apply_(r):
            dp = base(r)
            dp_b = K_bb_inv @ (r[ib] - (K[ib] @ np.where(mb, 0.0, dp)))
            dp = dp.copy()
            dp[ib] = dp_b
            return np.where(pin, r, dp)
        return apply_

    # pressure convection-diffusion (Elman-Silvester-Wathen):
    # Ŝ⁻¹ = M_p⁻¹ F_p A_p⁻¹ (production 'pcd' parity) or the reversed
    # A_p⁻¹ F_p M_p⁻¹ order — measured here against the TRUE
    # (exact-velocity-elimination) Schur operator to diagnose why the
    # production 'pcd' stagnates Newton on convection-dominated solves
    def make_pcd(rev=False):
        Gxp = sp.kron(sp.csr_matrix(grid.G1x), sp.diags(grid.m1y)).tocsr()
        Gyp = sp.kron(sp.diags(grid.m1x), sp.csr_matrix(grid.G1y)).tocsr()
        Fp = K if u is None else (
            K + Re * (sp.diags(u) @ Gxp + sp.diags(v) @ Gyp)).tocsr()
        Kpin = K.tolil(copy=True)
        ip = int(np.where(pin)[0][0])
        Kpin[ip, :] = 0.0
        Kpin[ip, ip] = 1.0
        lup = spla.splu(Kpin.tocsc())

        def apply_fwd(r):
            t = lup.solve(np.where(mb | pin, 0.0, r))
            dp = (Fp @ t) / md
            dp = np.where(mb, r / sd, dp)
            return np.where(pin, r, dp)

        def apply_rev(r):
            t = Fp @ (np.where(mb | pin, 0.0, r) / md)
            dp = lup.solve(t)
            dp = np.where(mb, r / sd, dp)
            return np.where(pin, r, dp)

        return apply_rev if rev else apply_fwd

    cands = {"mass": lambda: mass_inv, "mass+bb": lambda: mass_bb_inv,
             "bfbt": make_bfbt, "diagS": make_diagS,
             "einv": lambda: make_tensor("einv"),
             "specS": lambda: make_tensor("specS"),
             "specS+bb": make_specs_bb,
             "pcd": make_pcd,
             "pcd_rev": lambda: make_pcd(rev=True)}
    names = candidates or ["mass", "specS", "specS+bb"]
    wind = (f"lid Re={Re:g}" if lid_re is not None
            else "wind" if with_wind else "stokes")
    print(f"P={P} Ne={Ne} N={N} ({wind}):", flush=True)
    for name in names:
        Mi = cands[name]()
        if Mi is None:
            continue
        it, res = gmres_count(S_mv, N, Mi)
        print(f"  {name:8s} gmres_iters={it:5d} final_rel={res:.1e}",
              flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    wind = "--wind" in args
    args = [a for a in args if a != "--wind"]
    lid_re = None
    if "--lid" in args:
        i = args.index("--lid")
        lid_re = float(args[i + 1])
        del args[i:i + 2]
    cands_arg = None
    if "--cands" in args:
        i = args.index("--cands")
        cands_arg = args[i + 1].split(",")
        del args[i:i + 2]
    vals = [int(a) for a in args]
    configs = (list(zip(vals[::2], vals[1::2])) if vals
               else [(4, 4), (4, 8), (4, 16), (8, 8), (8, 16)])
    for (P, Ne) in configs:
        run_config(P, Ne, with_wind=wind, lid_re=lid_re,
                   candidates=cands_arg)
