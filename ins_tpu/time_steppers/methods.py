"""ODE method definitions.

Re-design of IncompressibleNavierStokes.jl `src/time_steppers/methods.jl`.
Methods are frozen (hashable) dataclasses holding Butcher tableaus as nested
tuples of Python floats — static under `jit`, so stage coefficients fold
into the compiled step.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ExplicitRungeKuttaMethod",
    "ImplicitRungeKuttaMethod",
    "LMWray3",
    "AdamsBashforthCrankNicolsonMethod",
    "OneLegMethod",
    "runge_kutta_method",
]


@dataclasses.dataclass(frozen=True)
class ExplicitRungeKuttaMethod:
    """Explicit RK with per-stage pressure projection (reference
    src/time_steppers/methods.jl:184-190). The tableau is stored *shifted*
    (row i holds original row i+1; last row is b), as in
    `runge_kutta_method` (methods.jl:222-240)."""

    A: tuple  # (s, s) nested tuple, shifted
    b: tuple
    c: tuple  # shifted; last entry 1
    r: float = 0.0
    p_add_solve: bool = True

    @property
    def nstage(self):
        return len(self.b)


@dataclasses.dataclass(frozen=True)
class ImplicitRungeKuttaMethod:
    A: tuple
    b: tuple
    c: tuple
    r: float = 0.0
    newton_type: str = "full"
    maxiter: int = 10
    abstol: float = 1e-14
    reltol: float = 1e-14
    p_add_solve: bool = True

    @property
    def nstage(self):
        return len(self.b)


@dataclasses.dataclass(frozen=True)
class LMWray3:
    """Low-storage 3-stage Wray RK3 (reference step_lmwray3.jl:65-80)."""

    a: tuple = (8 / 15, 5 / 12, 3 / 4)
    b: tuple = (1 / 4, 0.0)
    c: tuple = (0.0, 8 / 15, 2 / 3)


@dataclasses.dataclass(frozen=True)
class AdamsBashforthCrankNicolsonMethod:
    """IMEX: Adams-Bashforth convection + Crank-Nicolson diffusion
    (reference methods.jl:74-88). The implicit-diffusion solve runs as a
    matrix-free CG on device (instead of the reference's cached LU)."""

    alpha1: float = 1.5
    alpha2: float = -0.5
    theta: float = 0.5
    p_add_solve: bool = True
    # First step runs this one-step method to build the AB history at
    # full order (reference methods.jl:74-88). None -> RK44; False ->
    # first-order `c_{-1} = c_0` startup.
    method_startup: object = None


@dataclasses.dataclass(frozen=True)
class OneLegMethod:
    """Verstappen symmetry-preserving one-leg beta method
    (reference methods.jl:126-132)."""

    beta: float = 0.5
    p_add_solve: bool = True
    # First step runs this one-step method (reference methods.jl:126-132).
    # None -> RK44; False -> first-order `u_{-1} = u_0` startup.
    method_startup: object = None


def _tup(m):
    m = np.asarray(m, dtype=np.float64)
    if m.ndim == 1:
        return tuple(float(v) for v in m)
    return tuple(tuple(float(v) for v in row) for row in m)


def runge_kutta_method(A, b, c, r, **kwargs):
    """Build an RK method from a Butcher tableau; explicit tableaus are
    shifted (A[1:] + [b]; c[1:] + [1]) exactly as the reference
    (methods.jl:222-240)."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    s = A.shape[0]
    assert A.shape == (s, s) and len(b) == s and len(c) == s
    isexplicit = np.allclose(np.triu(A), 0.0)
    if isexplicit:
        A = np.vstack([A[1:, :], b[None, :]])
        c = np.append(c[1:], 1.0)
        return ExplicitRungeKuttaMethod(
            A=_tup(A), b=_tup(b), c=_tup(c), r=float(r), **kwargs
        )
    return ImplicitRungeKuttaMethod(
        A=_tup(A), b=_tup(b), c=_tup(c), r=float(r), **kwargs
    )
