"""The reference CG recurrence (HPCCG.cpp:312-402) in plain torch.

    p = x0; Ap = A p; r = b - Ap; rtrans = r.r; normr = sqrt(rtrans)
    for k = 1 .. max_iter-1 while normr > tolerance:
        if k == 1: p = r
        else:      oldrtrans = rtrans; rtrans = r.r; p = r + (rtrans/oldrtrans) p
        normr = sqrt(rtrans)                       (trace[k], the printed residual)
        Ap = A p; alpha = rtrans / (p.Ap)
        x = x + alpha p; r = r - alpha Ap
        niters = k

``trace[0]`` is the initial residual. The exit test reads normr on the host
each iteration: the reference is run once per right-hand side after the
measured window, never timed.
"""

from __future__ import annotations

import torch


def cg(matvec, b: torch.Tensor, x0: torch.Tensor, *, max_iter: int, tolerance: float = 0.0) -> dict:
    """Solve A x = b from x0; returns ``x``, ``niters`` (int), ``normr``
    (the residual at the top of the last iteration run, a float) and
    ``trace`` (a float64 tensor of max_iter entries, NaN past niters)."""
    x = x0.clone()
    r = b - matvec(x0)
    rtrans = torch.dot(r, r)
    normr = torch.sqrt(rtrans)
    trace = [normr]
    p = None
    niters = 0
    k = 1
    while k < max_iter and float(normr) > tolerance:
        if k == 1:
            p = r.clone()
        else:
            oldrtrans = rtrans
            rtrans = torch.dot(r, r)
            p = r + (rtrans / oldrtrans) * p
        normr = torch.sqrt(rtrans)
        trace.append(normr)
        Ap = matvec(p)
        alpha = rtrans / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        niters = k
        k += 1
    out = torch.full((max(max_iter, 1),), float("nan"), dtype=torch.float64, device=b.device)
    out[: len(trace)] = torch.stack(trace).to(torch.float64)
    return {"x": x, "niters": niters, "normr": float(normr), "trace": out}
