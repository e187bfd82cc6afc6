"""Offline coupled-saddle preconditioner diagnostics (real-wind, true norm).

Measures FGMRES iteration counts on the FULL coupled Newton saddle system
under production-style block upper-triangular preconditioners, linearized
at the ACTUAL converged Re=400 lid-cavity solution, with a CONSISTENT
smooth RHS ``b = J x_smooth``.

**The RHS choice is load-bearing** (CLAUDE.md lesson 7, re-learned here the
hard way): with a raw random ``b`` every candidate appeared to stall near
rel ~3e-3–1 (pcd and augmented-Lagrangian at "no progress"), because a
random RHS excites rough/near-spurious components actual Newton residuals
never contain.  With the consistent RHS the same candidates converge and
rank completely differently.

Round-3 findings at Re=400, P=8 8x8, rtol 1e-6 (consistent RHS):

  spectral + plain FDM velocity apply      : 1000 its -> rel 4.7e-6
  spectral + GMRES(5)-FDM inner velocity   :  376 its -> rel 9.4e-7  <-- WIN
  spectral + GMRES(20)-FDM inner velocity  :  382 its (5 is the knee)
  pcd Schur                                : 1000 its -> rel 8.5e-5
  augmented-Lagrangian gamma=0.3           :  961 its; gamma=1 diverges

=> The round-4 convection lever is a FLEXIBLE coupled loop (the inner
velocity GMRES is nonlinear per application) with ~5 FDM-preconditioned
inner velocity iterations per preconditioner application and the existing
spectral Schur block — NOT a Schur-block swap (pcd) and NOT AL.

Usage: python study/coupled_pc_diag.py [--synthetic] [--random-rhs]
       --synthetic : O(1) vortex wind instead of the converged solution
       --random-rhs: reproduce the misleading random-RHS numbers
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from sem_jax.mesh import Grid2D
from schur_spectrum import build_blocks

P, Ne, Re = 8, 8, 400.0
grid = Grid2D(P, Ne, Ne, 1.0, 1.0)
N = grid.N

if "--synthetic" in sys.argv:
    x, y = grid.points
    u = np.sin(np.pi * x) ** 2 * np.sin(2 * np.pi * y)
    v = -np.sin(2 * np.pi * x) * np.sin(np.pi * y) ** 2
    print("wind: synthetic O(1) vortex")
else:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sem_jax import NavierStokesSolver
    ns = NavierStokesSolver(1.0, 1.0, Re=Re, Gr=0.0, P=P, N_ex=Ne, N_ey=Ne,
                            u_N=1.0, iprint=[])
    uj, vj, _ = ns._get_solution(jnp.zeros(N))
    u, v = np.asarray(uj), np.asarray(vj)
    print(f"wind: converged lid-cavity solution (|u|max={np.abs(u).max():.3f})")

A, G, B, C, K, mb, pin = build_blocks(grid, Re=Re, u=u, v=v)
md, sd = grid.mass_diag, grid.stiff_diag


def J_mv(q):
    du, dp = q[:2 * N], q[2 * N:]
    return np.concatenate([A @ du + G @ dp, B @ du + C @ dp])


if "--random-rhs" in sys.argv:
    b0 = np.random.default_rng(3).standard_normal(3 * N)
    print("RHS: raw random (MISLEADING — see module docstring)")
else:
    x, y = grid.points
    sm = lambda kx, ky: np.sin(kx * np.pi * x) * np.cos(ky * np.pi * y)
    x_true = np.concatenate([sm(2, 1) + 0.5 * sm(3, 2),
                             sm(1, 2) - 0.5 * sm(2, 3),
                             sm(1, 1) + sm(2, 2)])
    b0 = J_mv(x_true)
    print("RHS: consistent smooth (b = J x_smooth)")

# diffusion-only velocity block (what the production FDM inverts)
Kd = build_blocks(grid, Re=Re, u=None, v=None)[0]
lu_Kd = spla.splu(Kd.tocsc())


# --- spectral Schur block (+ boundary-ring elimination), as production ---
def _e_pencil(G1, m1):
    Ex = G1.T @ np.diag(1.0 / m1) @ G1
    s = 1.0 / np.sqrt(m1)
    A1 = (Ex * s[:, None]) * s[None, :]
    A1 = 0.5 * (A1 + A1.T)
    lam, Q = scipy.linalg.eigh(A1)
    return lam, s[:, None] * Q


ex, Zx = _e_pencil(grid.G1x, grid.m1x)
ey, Zy = _e_pencil(grid.G1y, grid.m1y)
lx = np.einsum("ij,ik,kj->j", Zx, grid.K1x, Zx)
ly = np.einsum("ij,ik,kj->j", Zy, grid.K1y, Zy)
esum = ex[:, None] + ey[None, :]
ksum = lx[:, None] + ly[None, :]
scale = np.max(np.abs(esum))
ginv = np.where(np.abs(esum) > 1e-14 * scale, ksum / esum, 0.0)
ib = np.where(mb)[0]
K_bb_inv = np.linalg.inv(K[np.ix_(ib, ib)].toarray())


def shat_spec(rp):
    r_int = np.where(mb | pin, 0.0, rp).reshape(grid.Ngx, grid.Ngy)
    dp = (Zx @ (ginv * (Zx.T @ r_int @ Zy)) @ Zy.T).reshape(-1)
    dp = np.where(mb, rp / sd, dp)
    dp_b = K_bb_inv @ (rp[ib] - (K[ib] @ np.where(mb, 0.0, dp)))
    dp = dp.copy()
    dp[ib] = dp_b
    return np.where(pin, rp, dp)


# --- pcd Schur block (production-equivalent formulation) ---
Gxp = sp.kron(sp.csr_matrix(grid.G1x), sp.diags(grid.m1y)).tocsr()
Gyp = sp.kron(sp.diags(grid.m1x), sp.csr_matrix(grid.G1y)).tocsr()
Fp = (K + Re * (sp.diags(u) @ Gxp + sp.diags(v) @ Gyp)).tocsr()
Kpin = K.tolil(copy=True)
ip = int(np.where(pin)[0][0])
Kpin[ip, :] = 0.0
Kpin[ip, ip] = 1.0
lup = spla.splu(Kpin.tocsc())


def shat_pcd(rp):
    t = lup.solve(np.where(mb | pin, 0.0, rp))
    dp = (Fp @ t) / md
    dp = np.where(mb, rp / sd, dp)
    return np.where(pin, rp, dp)


def velo_gmres(b2, steps):
    """``steps`` of FDM(diffusion)-right-preconditioned GMRES on the TRUE
    Newton velocity block — the flexible inner solve a production
    candidate would run (nonlinear per application => FGMRES outer)."""
    xg = np.zeros(2 * N)
    r = b2.copy()
    beta = np.linalg.norm(r)
    if beta == 0:
        return xg
    V = [r / beta]
    Zs = []
    m = steps
    H = np.zeros((m + 1, m))
    g = np.zeros(m + 1)
    g[0] = beta
    cs = np.zeros(m)
    sn = np.zeros(m)
    kk = 0
    for k in range(m):
        z = lu_Kd.solve(V[k])
        w = A @ z
        Zs.append(z)
        for j in range(k + 1):
            H[j, k] = V[j] @ w
            w = w - H[j, k] * V[j]
        H[k + 1, k] = np.linalg.norm(w)
        V.append(w / max(H[k + 1, k], 1e-300))
        for j in range(k):
            t1 = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
            t2 = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
            H[j, k], H[j + 1, k] = t1, t2
        d = np.hypot(H[k, k], H[k + 1, k])
        cs[k], sn[k] = H[k, k] / d, H[k + 1, k] / d
        H[k, k] = d
        H[k + 1, k] = 0
        g[k + 1] = -sn[k] * g[k]
        g[k] = cs[k] * g[k]
        kk = k + 1
    yv = np.linalg.solve(np.triu(H[:kk, :kk]), g[:kk])
    return np.stack(Zs[:kk], axis=1) @ yv


def make_pc(shat, vsteps=0):
    def pc(r):
        ru2, rp = r[:2 * N], r[2 * N:]
        dp = shat(rp)
        b2 = ru2 - (G @ dp)
        duv = lu_Kd.solve(b2) if vsteps == 0 else velo_gmres(b2, vsteps)
        return np.concatenate([duv, dp])
    return pc


def fgmres_count(mv, pc, b, rtol=1e-6, maxiter=1000, restart=200):
    bn = np.linalg.norm(b)
    n = b.shape[0]
    x = np.zeros(n)
    it = 0
    while it < maxiter:
        r = b - mv(x)
        beta = np.linalg.norm(r)
        if beta <= rtol * bn:
            return it, beta / bn
        m = min(restart, maxiter - it)
        V = [r / beta]
        Zs = []
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.zeros(m)
        sn = np.zeros(m)
        kk = 0
        for k in range(m):
            z = pc(V[k])
            w = mv(z)
            Zs.append(z)
            for j in range(k + 1):
                H[j, k] = V[j] @ w
                w = w - H[j, k] * V[j]
            H[k + 1, k] = np.linalg.norm(w)
            V.append(w / max(H[k + 1, k], 1e-300))
            for j in range(k):
                t1 = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                t2 = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                H[j, k], H[j + 1, k] = t1, t2
            d = np.hypot(H[k, k], H[k + 1, k])
            cs[k], sn[k] = H[k, k] / d, H[k + 1, k] / d
            H[k, k] = d
            H[k + 1, k] = 0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            it += 1
            kk = k + 1
            if abs(g[k + 1]) <= rtol * bn:
                break
        yv = np.linalg.solve(np.triu(H[:kk, :kk]), g[:kk])
        x = x + np.stack(Zs[:kk], axis=1) @ yv
    r = b - mv(x)
    return it, np.linalg.norm(r) / bn


if __name__ == "__main__":
    for label, pc in (
            ("spectral + FDM velocity      ", make_pc(shat_spec)),
            ("spectral + GMRES(5) velocity ", make_pc(shat_spec, 5)),
            ("spectral + GMRES(20) velocity", make_pc(shat_spec, 20)),
            ("pcd      + FDM velocity      ", make_pc(shat_pcd))):
        it, res = fgmres_count(J_mv, pc, b0)
        print(f"{label}: iters={it:5d} rel={res:.2e}", flush=True)

    # augmented Lagrangian (Benzi-Olshanskii), exact A_gamma solve:
    # measured NOT competitive here (gamma=0.3: ~960 its; gamma=1 diverges
    # with the artificial pressure-boundary rows of this discretization)
    Minv2 = sp.diags(1.0 / md)
    GD = (G @ Minv2 @ B).tocsr()
    mb2 = np.concatenate([mb, mb])
    GD = GD.tolil()
    GD[np.where(mb2)[0], :] = 0.0
    GD = GD.tocsr()
    for gamma in (0.3, 1.0):
        lu_Ag = spla.splu((A + gamma * GD).tocsc())

        def pc(r, lu_Ag=lu_Ag, gamma=gamma):
            ru2, rp = r[:2 * N], r[2 * N:]
            dp = (1.0 + gamma) * rp / md
            dp = np.where(mb, rp / sd, dp)
            dp = np.where(pin, rp, dp)
            duv = lu_Ag.solve(ru2 - (G @ dp))
            return np.concatenate([duv, dp])

        it, res = fgmres_count(J_mv, pc, b0)
        print(f"AL gamma={gamma:3g} (exact A_g)     : iters={it:5d} "
              f"rel={res:.2e}", flush=True)
