"""Linear-program solvers for the Trevor data-flow model (§3.1.2).

Two implementations of the same dense two-phase primal simplex:

* :func:`linprog` — a plain-numpy implementation (Bland's rule,
  anti-cycling, handles infeasible/unbounded): the solver of the host-side
  control plane (the flow solver, the allocator) and the oracle the batched
  solver is tested against.  A copy of the reference package's.

* :func:`torch_linprog` — a fixed-shape tableau simplex in PyTorch, batched
  over a leading axis of ``c``/``b_ub``/``b_eq`` with shared ``A``
  matrices, on the card: many capacity vectors solved at once.  The
  counterpart of the reference's vmapped ``jax_linprog``.

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
import torch

from ..device import resolve_device

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


# ---------------------------------------------------------------------------
# PyTorch fixed-shape batched simplex
# ---------------------------------------------------------------------------

#: Pivots between two host checks of whether any batch row is still
#: pivoting.  Each check is a device sync; a row that has stopped keeps its
#: tableau through the pivots after it, so the result does not depend on
#: this number.
CHECK_EVERY = 32


def _pivots(T, basis, m, maxiter, tol):
    """Bland's-rule pivots on every batch row of tableau ``T`` until each
    has stopped at optimal (status 0) or unbounded (3), or ``maxiter``
    pivots have run (status 1).  A row that has stopped keeps ``T`` and
    ``basis`` exactly while the others go on.  Returns ``(T, basis,
    status)``."""
    B = T.shape[0]
    f = T.dtype
    rows = torch.arange(B, device=T.device)
    big = torch.tensor(1e30, dtype=f, device=T.device)
    one = torch.tensor(1.0, dtype=f, device=T.device)
    tie_scale = torch.tensor(1 + 1e-9, dtype=f, device=T.device)   # exactly 1 in float32
    int_max = torch.iinfo(torch.int32).max
    status = torch.full((B,), -1, dtype=torch.int32, device=T.device)
    for step in range(maxiter):
        if step % CHECK_EVERY == 0 and not bool((status == -1).any()):
            break
        active = status == -1
        can_enter = T[:, -1, :-1] < -tol
        enter = can_enter.to(torch.uint8).argmax(1)        # first True (Bland)
        done = ~can_enter.any(1)
        col = T[rows, :m, enter]
        pos = col > tol
        ratio = torch.where(pos, T[:, :m, -1] / torch.where(pos, col, one), big)
        rmin = ratio.min(1, keepdim=True).values
        tie = ratio <= rmin * tie_scale + tol
        leave = torch.where(tie & pos, basis, int_max).argmin(1)   # smallest basis index
        unbounded = ~pos.any(1)
        keep = ~active | done | unbounded
        prow = T[rows, leave]
        piv = prow / prow[rows, enter][:, None]
        colvals = T[rows, :, enter].index_put((rows, leave), torch.zeros((), dtype=f, device=T.device))
        # rows that keep their tableau subtract an exact +0.0
        colvals = torch.where(keep[:, None], 0.0, colvals)
        piv_upd = torch.where(keep[:, None], 0.0, piv)
        T = T - colvals[:, :, None] * piv_upd[:, None, :]
        T[rows, leave] = torch.where(keep[:, None], prow, piv)
        basis = torch.where(keep[:, None], basis,
                            basis.index_put((rows, leave), enter))
        new_status = torch.where(done, STATUS_OPTIMAL, torch.where(unbounded, STATUS_UNBOUNDED, -1))
        status = torch.where(active, new_status.to(status.dtype), status)
    return T, basis, torch.where(status == -1, STATUS_MAXITER, status)


def torch_linprog(c, A_ub, b_ub, A_eq, b_eq, maxiter: int = 1024, tol: float = 1e-6,
                  dtype: torch.dtype = torch.float32, device=None):
    """Fixed-shape two-phase tableau simplex in PyTorch.

    All arguments are dense arrays or tensors (zero rows for absent
    constraints).  ``c``, ``b_ub`` and ``b_eq`` may carry a leading batch
    axis (``A_ub`` and ``A_eq`` are shared); an unbatched call gives
    unbatched outputs.  Returns ``(x, fun, status)`` tensors with the same
    status codes as :func:`linprog`; ``x`` and ``fun`` are NaN where the
    solve is not optimal (``fun`` is -inf where it is unbounded).

    minimize c@x  s.t.  A_ub x <= b_ub, A_eq x = b_eq, x >= 0.

    Each batch row pivots until it stops (Bland's rule, the basis index
    breaking ratio ties) or reaches ``maxiter``; a stopped row is frozen
    while the others go on, so each row is its own unbatched solve.  Phase
    2 keeps the artificial columns under a Big-M cost, so a degenerate
    basic artificial can never silently grow.  ``dtype`` is the tableau's:
    float32 by default (the reference's precision), float64 for a solve that
    must agree with :func:`linprog` closely.  ``device=None`` is the CUDA
    card.
    """
    dev = resolve_device(device)
    f = dtype
    c, A_ub, b_ub, A_eq, b_eq = (torch.as_tensor(a, dtype=f, device=dev)
                                 for a in (c, A_ub, b_ub, A_eq, b_eq))
    batched = c.ndim == 2 or b_ub.ndim == 2 or b_eq.ndim == 2
    c, b_ub, b_eq = (a if a.ndim == 2 else a[None] for a in (c, b_ub, b_eq))
    B = max(c.shape[0], b_ub.shape[0], b_eq.shape[0])
    c, b_ub, b_eq = (a.expand(B, -1) for a in (c, b_ub, b_eq))
    n = c.shape[1]
    m_ub, m_eq = A_ub.shape[0], A_eq.shape[0]
    m = m_ub + m_eq
    n_sa = n + m_ub
    width = n_sa + m + 1  # + artificial per row + RHS

    A = torch.zeros(m, n_sa, dtype=f, device=dev)
    A[:m_ub, :n] = A_ub
    A[:m_ub, n:] = torch.eye(m_ub, dtype=f, device=dev)
    A[m_ub:, :n] = A_eq
    b = torch.cat([b_ub, b_eq], dim=1)
    sgn = torch.where(b < 0, -1.0, 1.0).to(f)
    A = A[None] * sgn[:, :, None]
    b = b * sgn

    slack_ok = torch.cat([sgn[:, :m_ub] > 0, torch.zeros(B, m_eq, dtype=torch.bool, device=dev)], 1)
    slack_idx = torch.cat([n + torch.arange(m_ub, device=dev),
                           torch.zeros(m_eq, dtype=torch.int64, device=dev)])
    art_idx = n_sa + torch.arange(m, device=dev)
    basis0 = torch.where(slack_ok, slack_idx, art_idx)

    T0 = torch.zeros(B, m + 1, width, dtype=f, device=dev)
    T0[:, :m, :n_sa] = A
    T0[:, :m, n_sa:n_sa + m] = torch.eye(m, dtype=f, device=dev)
    T0[:, :m, -1] = b
    art_active = (~slack_ok).to(f)
    obj1 = torch.zeros(B, width, dtype=f, device=dev)
    obj1[:, n_sa:n_sa + m] = art_active
    T0[:, -1] = obj1 - (art_active[:, :, None] * T0[:, :m]).sum(1)
    del A, obj1

    T1, basis1, st1 = _pivots(T0, basis0, m, maxiter, tol)
    del T0
    infeasible = -T1[:, -1, -1] > 1e-4 * torch.clamp(b.abs().amax(1), min=1.0)

    # Phase 2 with Big-M on artificials (columns kept intact).
    M = 1e7 * torch.clamp(c.abs().amax(1), min=1.0)
    cost_full = torch.zeros(B, width, dtype=f, device=dev)
    cost_full[:, :n] = c
    cost_full[:, n_sa:n_sa + m] = M[:, None]
    cB = cost_full.gather(1, basis1)
    T1[:, -1] = cost_full - (cB[:, :, None] * T1[:, :m]).sum(1)
    T3, basis3, st2 = _pivots(T1, basis1, m, maxiter, tol)
    del T1

    x = torch.zeros(B, width, dtype=f, device=dev).scatter(1, basis3, T3[:, :m, -1])[:, :n]
    fun = (c * x).sum(1)
    status = torch.where(infeasible, STATUS_INFEASIBLE,
                         torch.where(st1 == STATUS_MAXITER, STATUS_MAXITER, st2)).to(torch.int32)
    ok = status == STATUS_OPTIMAL
    nan = torch.tensor(float("nan"), dtype=f, device=dev)
    x = torch.where(ok[:, None], x, nan)
    fun = torch.where(ok, fun, torch.where(status == STATUS_UNBOUNDED, -torch.inf, nan))
    if not batched:
        return x[0], fun[0], status[0]
    return x, fun, status
