"""Linear-program solvers for the Trevor data-flow model (§3.1.2).

:func:`linprog` is a dense two-phase primal simplex in plain numpy (Bland's
rule, anti-cycling, handles infeasible/unbounded) — the solver of the
host-side control plane (the flow solver, the allocator).  A copy of the
reference package's numpy solver; the batched fixed-shape simplex is not
part of this package yet.

Convention (mirrors ``scipy.optimize.linprog``):

    minimize    c @ x
    subject to  A_ub @ x <= b_ub
                A_eq @ x == b_eq
                x >= 0

Statuses: 0 = optimal, 1 = iteration limit, 2 = infeasible, 3 = unbounded.
"""
from __future__ import annotations

import dataclasses

import numpy as np

STATUS_OPTIMAL = 0
STATUS_MAXITER = 1
STATUS_INFEASIBLE = 2
STATUS_UNBOUNDED = 3


@dataclasses.dataclass
class LPResult:
    x: np.ndarray
    fun: float
    status: int
    nit: int
    slack: np.ndarray  # b_ub - A_ub @ x (empty if no ub constraints)

    @property
    def success(self) -> bool:
        return self.status == STATUS_OPTIMAL


# ---------------------------------------------------------------------------
# numpy reference implementation
# ---------------------------------------------------------------------------


def _pivot(T: np.ndarray, basis: np.ndarray, row: int, col: int) -> None:
    """In-place Gauss-Jordan pivot of tableau ``T`` on (row, col)."""
    T[row] /= T[row, col]
    colvals = T[:, col].copy()
    colvals[row] = 0.0
    T -= np.outer(colvals, T[row])
    basis[row] = col


def _simplex_iterate(
    T: np.ndarray,
    basis: np.ndarray,
    n_cols: int,
    maxiter: int,
    tol: float,
) -> tuple[int, int]:
    """Run primal simplex on tableau ``T`` (objective in last row, RHS in last
    column) restricted to the first ``n_cols`` columns.  Bland's rule.

    Returns (status, iterations). status 0 = optimal reached, 3 = unbounded,
    1 = iteration limit.
    """
    m = T.shape[0] - 1
    for it in range(maxiter):
        neg = np.where(T[-1, :n_cols] < -tol)[0]
        if neg.size == 0:
            return STATUS_OPTIMAL, it
        enter = int(neg[0])  # Bland: smallest index
        col = T[:m, enter]
        pos = col > tol
        if not pos.any():
            return STATUS_UNBOUNDED, it
        ratios = np.full(m, np.inf)
        ratios[pos] = T[:m, -1][pos] / col[pos]
        rmin = ratios.min()
        ties = np.where(ratios <= rmin + tol)[0]
        leave = int(ties[np.argmin(basis[ties])])  # Bland tie-break
        _pivot(T, basis, leave, enter)
    return STATUS_MAXITER, maxiter


def linprog(
    c,
    A_ub=None,
    b_ub=None,
    A_eq=None,
    b_eq=None,
    maxiter: int = 20_000,
    tol: float = 1e-9,
) -> LPResult:
    """Dense two-phase simplex.  See module docstring for the convention."""
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    A_ub = np.zeros((0, n)) if A_ub is None else np.asarray(A_ub, dtype=np.float64)
    b_ub = np.zeros((0,)) if b_ub is None else np.atleast_1d(np.asarray(b_ub, dtype=np.float64))
    A_eq = np.zeros((0, n)) if A_eq is None else np.asarray(A_eq, dtype=np.float64)
    b_eq = np.zeros((0,)) if b_eq is None else np.atleast_1d(np.asarray(b_eq, dtype=np.float64))
    if A_ub.shape != (b_ub.shape[0], n) or A_eq.shape != (b_eq.shape[0], n):
        raise ValueError("constraint shapes inconsistent with objective")

    m_ub, m_eq = A_ub.shape[0], A_eq.shape[0]
    m = m_ub + m_eq

    # Assemble equality-standard-form rows [A | slack] with nonnegative RHS.
    A = np.zeros((m, n + m_ub))
    b = np.concatenate([b_ub, b_eq])
    A[:m_ub, :n] = A_ub
    A[:m_ub, n : n + m_ub] = np.eye(m_ub)
    A[m_ub:, :n] = A_eq
    neg = b < 0
    A[neg] *= -1.0
    b = np.abs(b)

    # Basis: slack columns where they form a unit vector (+1) in their row,
    # artificials elsewhere.
    n_sa = n + m_ub  # structural + slack columns
    need_art = [i for i in range(m_ub) if neg[i]] + list(range(m_ub, m))
    basis = np.full(m, -1, dtype=np.int64)
    for i in range(m_ub):
        if not neg[i]:
            basis[i] = n + i  # slack basic
    n_art = len(need_art)
    T = np.zeros((m + 1, n_sa + n_art + 1))
    T[:m, :n_sa] = A
    T[:m, -1] = b
    for k, i in enumerate(need_art):
        T[i, n_sa + k] = 1.0
        basis[i] = n_sa + k

    nit_total = 0
    if n_art > 0:
        # Phase 1: minimize sum of artificials.
        T[-1, :] = 0.0
        T[-1, n_sa : n_sa + n_art] = 1.0
        for i in range(m):  # make reduced costs consistent with basis
            if basis[i] >= n_sa:
                T[-1] -= T[i]
        status, nit = _simplex_iterate(T, basis, n_sa + n_art, maxiter, tol)
        nit_total += nit
        phase1_obj = -T[-1, -1]
        if status == STATUS_MAXITER:
            return LPResult(np.full(n, np.nan), np.nan, STATUS_MAXITER, nit_total, np.zeros(0))
        if phase1_obj > 1e-7 * max(1.0, np.abs(b).max()):
            return LPResult(np.full(n, np.nan), np.nan, STATUS_INFEASIBLE, nit_total, np.zeros(0))
        # Drive any basic artificials out (degenerate, at zero level).
        drop_rows = []
        for i in range(m):
            if basis[i] >= n_sa:
                nzcols = np.where(np.abs(T[i, :n_sa]) > 1e-8)[0]
                if nzcols.size:
                    _pivot(T, basis, i, int(nzcols[0]))
                else:
                    drop_rows.append(i)  # redundant constraint
        if drop_rows:
            keep = [i for i in range(m) if i not in set(drop_rows)]
            T = np.vstack([T[keep], T[-1:]])
            basis = basis[keep]
            m = len(keep)

    # Phase 2: restore the true objective over structural+slack columns.
    T[-1, :] = 0.0
    T[-1, :n] = c
    # Remove artificial columns so they can never re-enter (none are basic now).
    if n_art > 0:
        T[:, n_sa : n_sa + n_art] = 0.0
        T[-1, n_sa : n_sa + n_art] = 1.0  # positive reduced cost
    for i in range(m):
        bi = basis[i]
        if bi < n_sa and T[-1, bi] != 0.0:
            T[-1] -= T[-1, bi] * T[i]
    status, nit = _simplex_iterate(T, basis, n_sa, maxiter, tol)
    nit_total += nit
    if status == STATUS_UNBOUNDED:
        return LPResult(np.full(n, np.nan), -np.inf, STATUS_UNBOUNDED, nit_total, np.zeros(0))
    if status == STATUS_MAXITER:
        return LPResult(np.full(n, np.nan), np.nan, STATUS_MAXITER, nit_total, np.zeros(0))

    x_full = np.zeros(n_sa + n_art)
    x_full[basis] = T[:m, -1]
    x = x_full[:n]
    slack = b_ub - A_ub @ x if m_ub else np.zeros(0)
    return LPResult(x, float(c @ x), STATUS_OPTIMAL, nit_total, slack)


def linprog_maximize(c, **kwargs) -> LPResult:
    """Maximize ``c @ x`` (Trevor maximizes the source tuple-rate)."""
    res = linprog(-np.asarray(c, dtype=np.float64), **kwargs)
    if res.status == STATUS_OPTIMAL:
        res.fun = -res.fun
    elif res.status == STATUS_UNBOUNDED:
        res.fun = np.inf
    return res
