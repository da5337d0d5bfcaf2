import os

# Must be set before jax import: run tests on a virtual 8-device CPU mesh
# with float64 enabled (the structure-preserving property tests assert to
# 1e-12, matching the reference test suite which runs Float64).  An
# explicit JAX_PLATFORMS (e.g. `cuda` for the `gpu`-marked tests) wins.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

import ins_tpu as ins  # noqa: E402


def make_setup_2d(n=16, dtype=jnp.float64):
    """Mirror of reference test fixture Setup2D (test/operators.jl:1-24):
    tanh-stretched Dirichlet box with temperature and steady body force."""
    Re = 1000.0
    x = (
        ins.tanh_grid(0.0, 1.0, n),
        ins.tanh_grid(0.0, 1.0, n, 1.3),
    )
    bc = (ins.DirichletBC(), ins.DirichletBC())
    boundary_conditions = (bc, bc)
    temperature = ins.temperature_equation(
        Pr=0.71,
        Ra=1e6,
        Ge=1.0,
        boundary_conditions=boundary_conditions,
        dtype=dtype,
    )
    bodyforce = lambda dim, x, y, t: (dim == 0) * 5 * jnp.sin(8 * jnp.pi * y)
    setup = ins.Setup(
        x=x,
        boundary_conditions=boundary_conditions,
        Re=Re,
        temperature=temperature,
        bodyforce=bodyforce,
        issteadybodyforce=True,
        dtype=dtype,
    )
    return setup


def make_setup_3d(n=16, dtype=jnp.float64):
    """Mirror of reference test fixture Setup3D (test/operators.jl:26-49)."""
    Re = 1000.0
    x = (
        ins.tanh_grid(0.0, 1.0, n, 1.2),
        ins.tanh_grid(0.0, 1.0, n, 1.1),
        ins.cosine_grid(0.0, 1.0, n),
    )
    bc = (ins.DirichletBC(), ins.DirichletBC())
    boundary_conditions = (bc, bc, bc)
    temperature = ins.temperature_equation(
        Pr=0.71,
        Ra=1e6,
        Ge=1.0,
        boundary_conditions=boundary_conditions,
        dtype=dtype,
    )
    bodyforce = lambda dim, x, y, z, t: (dim == 0) * 5 * jnp.sin(8 * jnp.pi * y)
    setup = ins.Setup(
        x=x,
        boundary_conditions=boundary_conditions,
        Re=Re,
        temperature=temperature,
        bodyforce=bodyforce,
        issteadybodyforce=True,
        dtype=dtype,
    )
    return setup


def uref(dim, x, y, *args):
    return -(dim == 0) * jnp.sin(x) * jnp.cos(y) + (dim == 1) * jnp.cos(
        x
    ) * jnp.sin(y)


@pytest.fixture(scope="session")
def setup2d():
    return make_setup_2d()


@pytest.fixture(scope="session")
def setup3d():
    return make_setup_3d()


@pytest.fixture(scope="session")
def u2d(setup2d):
    from ins_tpu.ops.pressure import psolver_cg

    # Tight CG tolerance: the skew-symmetry property test needs a velocity
    # that is divergence-free to near machine precision (the reference
    # fixture uses an exact sparse direct solve here).
    return ins.velocityfield(
        setup2d, uref, 0.0, psolver=psolver_cg(setup2d, reltol=1e-13)
    )


@pytest.fixture(scope="session")
def u3d(setup3d):
    from ins_tpu.ops.pressure import psolver_cg

    return ins.velocityfield(
        setup3d, uref, 0.0, psolver=psolver_cg(setup3d, reltol=1e-13)
    )
