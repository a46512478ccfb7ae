"""Shapes of the reference's KPConv and linear calls, recorded while
`CALLS` is a list (the benchmark's operation and byte counts read them;
the rows are the padded rows of the plan, as the program computes)."""

from __future__ import annotations

CALLS = None


def conv(q_pts, s_pts, neighb_inds, x, weights) -> None:
    if CALLS is not None:
        b, nq = q_pts.shape[0], q_pts.shape[1]
        kp, cin, cout = weights.shape
        CALLS.append(("conv", dict(rows=b * nq, neighbors=neighb_inds.shape[-1],
                                   kernel_points=kp, cin=cin, cout=cout,
                                   supports=b * s_pts.shape[1],
                                   need_dx=bool(x.requires_grad))))


def linear(x, weight) -> None:
    if CALLS is not None:
        rows = x.numel() // x.shape[-1]
        CALLS.append(("linear", dict(rows=rows, cin=weight.shape[1],
                                     cout=weight.shape[0],
                                     need_dx=bool(x.requires_grad))))
