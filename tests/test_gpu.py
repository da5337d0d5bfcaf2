"""On-card checks of the main path (marker `gpu`).  They skip unless JAX's
first device is an NVIDIA GPU; run them there with

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins
from ins_tpu.ops.fastpath import make_fast_timestep, reghost, strip_ghosts
from ins_tpu.ops.pressure import spectral_inverse_laplacian
from ins_tpu.time_steppers.step import StepperState, timestep

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's device is {dev.platform}")
    return dev


def _setup(n, dtype):
    x = (np.linspace(0.0, 2 * np.pi, n + 1),) * 3
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    return ins.Setup(x=x, boundary_conditions=bc, Re=4000.0, dtype=dtype)


def test_fft_poisson_f32_on_card(gpu):
    """cuFFT's float32 spectral solve at 128^3 stays at f32 accuracy
    against float64 on the card (no multi-axis accuracy cliff)."""
    n = 128
    dx = 2 * np.pi / n
    f = jax.random.normal(jax.random.PRNGKey(0), (n,) * 3, jnp.float64)
    f = f - jnp.mean(f)

    def solve(f):
        inv = spectral_inverse_laplacian((n,) * 3, (dx,) * 3, f.dtype)
        return jnp.fft.irfftn(jnp.fft.rfftn(f) * inv, f.shape)

    p32 = jax.jit(solve)(f.astype(jnp.float32)).astype(jnp.float64)
    p64 = jax.jit(solve)(f)
    assert float(jnp.linalg.norm(p32 - p64) / jnp.linalg.norm(p64)) < 1e-5


@pytest.mark.parametrize("method", ["rk44", "lmwray3"])
def test_fast_step_f32_matches_f64_ghosted_on_card(gpu, method):
    """3 float32 fast-path steps at 64^3 on the card == the ghosted
    float64 stepper to f32 rounding."""
    m = ins.RKMethods.RK44() if method == "rk44" else ins.LMWray3()
    s32, s64 = _setup(64, jnp.float32), _setup(64, jnp.float64)
    u0 = jax.jit(lambda k: ins.random_field(s32, kp=10, rng=k))(
        jax.random.PRNGKey(1)
    )
    fast = jax.jit(make_fast_timestep(s32, m))
    ps64 = ins.psolver_spectral(s64)
    ghost = jax.jit(lambda s: timestep(m, s, 1e-3, setup=s64, psolver=ps64))
    a = StepperState(u=strip_ghosts(u0), temp=None,
                     t=jnp.asarray(0.0, jnp.float32), n=jnp.asarray(0))
    b = StepperState(u=u0.astype(jnp.float64), temp=None,
                     t=jnp.asarray(0.0, jnp.float64), n=jnp.asarray(0))
    for _ in range(3):
        a = fast(a, jnp.asarray(1e-3, jnp.float32), None)
        b = ghost(b)
    ua = reghost(a.u).astype(jnp.float64)[:, 1:-1, 1:-1, 1:-1]
    ub = b.u[:, 1:-1, 1:-1, 1:-1]
    assert float(jnp.linalg.norm(ua - ub) / jnp.linalg.norm(ub)) < 1e-5
