# ruff: noqa: F821, F841  (GTScript definitions: parsed DSL names and assigned outputs, never executed)
"""Exponentially-weighted vertical column integrals (optical-depth motif).

A pair of first-order vertical recurrences — downward (FORWARD) and upward
(BACKWARD) — of the kind radiation / microphysics columns run everywhere:
``acc(k) = decay * acc(k-1) + rho(k) * w(k)``.

The accumulator temporaries live entirely inside their sweep and are only
read one plane behind it, so ``analysis.sequential_carry_plan`` classifies
them as depth-1 *window* fields: the cuda backend keeps two rolling
shared-memory planes instead of materializing the full (ni, nj, nk) array.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.gtscript import BACKWARD, FORWARD, Field, computation, interval
from repro_torch.core.stencil import build_retyped

DEFAULT_DECAY = 0.9


def vintg_defs(
    rho: Field[np.float64],
    w: Field[np.float64],
    out_dn: Field[np.float64],
    out_up: Field[np.float64],
    *,
    decay: np.float64,
):
    """Downward and upward decaying column integrals of ``rho * w``."""
    with computation(FORWARD):
        with interval(0, 1):
            acc_dn = rho * w
            out_dn = acc_dn
        with interval(1, None):
            acc_dn = decay * acc_dn[0, 0, -1] + rho * w
            out_dn = acc_dn
    with computation(BACKWARD):
        with interval(-1, None):
            acc_up = rho * w
            out_up = acc_up
        with interval(0, -1):
            acc_up = decay * acc_up[0, 0, 1] + rho * w
            out_up = acc_up


@functools.lru_cache(maxsize=None)
def build_vintg(backend: str = "cuda", dtype: str = "float64", **opts):
    return build_retyped(vintg_defs, backend, dtype, **opts)
