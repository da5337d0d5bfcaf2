"""ins_tpu: accelerator-native incompressible Navier-Stokes framework.

A from-scratch JAX/XLA re-design with the capabilities of
IncompressibleNavierStokes.jl (energy-conserving staggered finite volumes,
four BC families, Boussinesq temperature, explicit RK time integration with
pressure projection, FFT/CG/direct Poisson solvers, Smagorinsky LES, full
differentiability, and a neural-closure training stack), built for the
accelerator first:
component-first field layout, fused stencils, jitted scan loops, sharding
over device meshes.
"""

from . import parallel, processors, utils  # noqa: F401
from .boundary_conditions import (  # noqa: F401
    DirichletBC,
    PeriodicBC,
    PressureBC,
    SymmetricBC,
    apply_bc_p,
    apply_bc_temp,
    apply_bc_u,
)
from .grid import (  # noqa: F401
    cosine_grid,
    make_grid,
    max_size,
    stretched_grid,
    tanh_grid,
)
from .ops import *  # noqa: F401,F403
from .processors import (  # noqa: F401
    Processor,
    fieldobserver,
    fieldsaver,
    get_streamfunction,
    jax_profiler,
    observe_nusselt,
    observe_wallshear,
    observefield,
    observespectrum,
    processor,
    save_vtk,
    timelogger,
    vtk_writer,
)
from .sciml import create_right_hand_side, right_hand_side  # noqa: F401
from .utils.spectrum import (  # noqa: F401
    get_lims,
    getoffset,
    splitseed,
)
from .utils.checkpoint import (  # noqa: F401
    async_checkpointer,
    checkpointer,
    load_async_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .setup import Setup, Temperature, temperature_equation  # noqa: F401
from .solver import (  # noqa: F401
    SolverDivergedError,
    get_cfl_timestep,
    get_state,
    solve_unsteady,
)
from .time_steppers import (  # noqa: F401
    LMWray3,
    RKMethods,
    create_stepper,
    runge_kutta_method,
    timestep,
)

__version__ = "0.1.0"

# Plotting names the reference exports from its main module
# (src/IncompressibleNavierStokes.jl:104,123 — implemented by the Makie
# ext; here by ins_tpu.plotting). Lazy so importing the solver never
# pulls matplotlib.
_PLOTTING_NAMES = (
    "plotgrid",
    "fieldplot",
    "realtimeplotter",
    "animator",
    "energy_history_plot",
    "energy_spectrum_plot",
)


def __getattr__(name):
    if name in _PLOTTING_NAMES:
        from . import plotting

        return getattr(plotting, name)
    raise AttributeError(f"module 'ins_tpu' has no attribute {name!r}")
