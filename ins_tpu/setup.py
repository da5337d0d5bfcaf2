"""Problem setup.

Equivalent of IncompressibleNavierStokes.jl `src/setup.jl`:
`Setup` is a frozen pytree dataclass (arrays traced, config static) instead
of a NamedTuple; `temperature_equation` mirrors the three
non-dimensionalization schemes (src/setup.jl:56-86).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np

from ._pytree import pytree_dataclass, static_field
from .boundary_conditions import PeriodicBC
from .grid import Grid, make_grid

__all__ = ["Setup", "Temperature", "temperature_equation"]


@pytree_dataclass
class Temperature:
    """Boussinesq temperature-equation coefficients (src/setup.jl:56-86)."""

    alpha1: Any
    alpha2: Any
    alpha3: Any
    alpha4: Any
    gamma: Any
    dodissipation: bool = static_field()
    boundary_conditions: tuple = static_field()
    gdir: int = static_field()


def temperature_equation(
    *,
    Pr,
    Ra,
    Ge,
    boundary_conditions,
    dodissipation=True,
    gdir=1,
    nondim_type=1,
    dtype=jnp.float32,
):
    """Create temperature-equation coefficients.

    `gdir` is the 0-based gravity direction (reference default `gdir = 2`
    in 1-based Julia = dimension index 1 here).
    """
    if nondim_type == 1:
        # Free-fall velocity scale, uref = sqrt(beta g DT H)
        a1 = math.sqrt(Pr / Ra)
        a2 = 1.0
        a3 = Ge * math.sqrt(Pr / Ra)
        a4 = 1 / math.sqrt(Pr * Ra)
    elif nondim_type == 2:
        # uref = kappa / H (heat-conduction time scale)
        a1 = Pr
        a2 = Pr * Ra
        a3 = Ge / Ra
        a4 = 1.0
    elif nondim_type == 3:
        # uref = sqrt(c DT)
        a1 = math.sqrt(Pr * Ge / Ra)
        a2 = Ge
        a3 = math.sqrt(Pr * Ge / Ra)
        a4 = math.sqrt(Ge / (Pr * Ra))
    else:
        raise ValueError(f"Unknown nondim_type {nondim_type}")
    gamma = a1 / a3
    arr = lambda v: jnp.asarray(v, dtype)
    return Temperature(
        alpha1=arr(a1),
        alpha2=arr(a2),
        alpha3=arr(a3),
        alpha4=arr(a4),
        gamma=arr(gamma),
        dodissipation=dodissipation,
        boundary_conditions=tuple(tuple(bc) for bc in boundary_conditions),
        gdir=gdir,
    )


@pytree_dataclass
class SetupData:
    """Problem setup (reference `Setup` NamedTuple, src/setup.jl:2-46)."""

    grid: Grid
    Re: Any
    temperature: Temperature | None
    bodyforce_field: Any  # precomputed steady body force, or None
    boundary_conditions: tuple = static_field()
    bodyforce: Callable | None = static_field(default=None)
    issteadybodyforce: bool = static_field(default=False)
    closure_model: Callable | None = static_field(default=None)
    dtype: Any = static_field(default=jnp.float32)

    @property
    def dim(self):
        return self.grid.dim


def Setup(
    *,
    x,
    boundary_conditions=None,
    Re=None,
    bodyforce=None,
    issteadybodyforce=True,
    closure_model=None,
    temperature=None,
    dtype=jnp.float32,
):
    """Build a problem setup.

    Mirrors reference kwargs (src/setup.jl:2-13); `backend`/`workgroupsize`
    are dropped (XLA owns scheduling), `dtype` selects precision (the
    reference infers it from the grid eltype).
    """
    D = len(x)
    if boundary_conditions is None:
        boundary_conditions = tuple((PeriodicBC(), PeriodicBC()) for _ in range(D))
    boundary_conditions = tuple(tuple(bc) for bc in boundary_conditions)
    if Re is None:
        Re = 1000.0 if temperature is None else 1.0 / float(temperature.alpha1)
    grid = make_grid(x=x, boundary_conditions=boundary_conditions, dtype=dtype)
    setup = SetupData(
        grid=grid,
        Re=jnp.asarray(Re, dtype),
        temperature=temperature,
        bodyforce_field=None,
        boundary_conditions=boundary_conditions,
        bodyforce=bodyforce,
        issteadybodyforce=False,
        closure_model=closure_model,
        dtype=dtype,
    )
    if bodyforce is not None and issteadybodyforce:
        from .ops.operators import applybodyforce

        field = applybodyforce(None, jnp.asarray(0.0, dtype), setup)
        setup = SetupData(
            grid=grid,
            Re=setup.Re,
            temperature=temperature,
            bodyforce_field=field,
            boundary_conditions=boundary_conditions,
            bodyforce=bodyforce,
            issteadybodyforce=True,
            closure_model=closure_model,
            dtype=dtype,
        )
    return setup
