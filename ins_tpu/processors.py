"""Processors: in-loop observability and I/O.

Re-design of IncompressibleNavierStokes.jl `src/processors.jl`. A processor
is `(initialize, update, finalize)` over host-side snapshots of the solver
state, pulled at chunk boundaries of the jitted scan (the reference updates
an `Observable` after every step; here `nupdate` decimation also sets the
scan chunk size, so no step-level host sync is ever forced).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Processor",
    "processor",
    "timelogger",
    "fieldsaver",
    "observefield",
    "fieldobserver",
    "observespectrum",
    "save_vtk",
    "vtk_writer",
    "get_streamfunction",
    "jax_profiler",
    "observe_nusselt",
    "observe_wallshear",
]


@dataclasses.dataclass
class Processor:
    initialize: Callable[[dict], Any]
    update: Callable[[Any, dict], Any]
    finalize: Callable[[Any, dict], Any]
    nupdate: int = 1


def processor(update, *, initialize=None, finalize=None, nupdate=1):
    """Build a processor from an update function `pstate, state -> pstate`
    (reference `processor`, src/processors.jl:22-40)."""
    return Processor(
        initialize=initialize or (lambda state: None),
        update=update,
        finalize=finalize or (lambda pstate, state: pstate),
        nupdate=nupdate,
    )


def timelogger(nupdate=1):
    """Log step number, time, umax and wall time per iteration
    (reference src/processors.jl:45-72)."""

    def initialize(state):
        return {"wall": time.perf_counter(), "n": int(state["n"])}

    def update(pstate, state):
        now = time.perf_counter()
        n = int(state["n"])
        itertime = (now - pstate["wall"]) / max(1, n - pstate["n"])
        umax = float(jnp.max(jnp.abs(state["u"])))
        print(
            f"Iteration {n}\tt = {float(state['t']):.3g}"
            f"\tΔt_wall = {itertime * 1e3:.3g} ms/it\tumax = {umax:.3g}"
        )
        return {"wall": now, "n": n}

    return Processor(initialize, update, lambda p, s: None, nupdate)


def fieldsaver(nupdate=1):
    """Keep host copies of the full state every `nupdate` steps
    (reference src/processors.jl:290-300)."""

    def initialize(state):
        return []

    def update(fields, state):
        fields.append(
            dict(
                u=np.asarray(state["u"]),
                temp=None if state["temp"] is None else np.asarray(state["temp"]),
                t=float(state["t"]),
            )
        )
        return fields

    return Processor(initialize, update, lambda fields, s: fields, nupdate)


def observefield(func, *, nupdate=1):
    """Record a derived quantity `func(state) -> value` every `nupdate`
    steps."""

    def initialize(state):
        return []

    def update(vals, state):
        vals.append(jax.device_get(func(state)))
        return vals

    return Processor(initialize, update, lambda vals, s: vals, nupdate)


def get_streamfunction(u, setup):
    """2D streamfunction psi with nabla^2 psi = -omega on uniform periodic
    grids (the reference references but never defines this; here it is a
    working spectral solve)."""
    import numpy as np

    from .ops._stencil import slc
    from .ops.operators import vorticity

    g = setup.grid
    assert g.dim == 2, "Streamfunction is 2D only"
    assert all(g.periodic) and all(g.uniform)
    w = vorticity(u, setup)
    ip = slc(g.Ip)
    wi = w[ip]
    Np = g.Np
    dx = [float(np.asarray(g.delta[d])[0]) for d in range(2)]
    kx = np.fft.fftfreq(Np[0]) * 2 * np.pi / dx[0]
    ky = np.fft.rfftfreq(Np[1]) * 2 * np.pi / dx[1]
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    k2[0, 0] = 1.0
    inv_k2 = 1.0 / k2
    inv_k2[0, 0] = 0.0  # zero-mean mode folded in (no runtime scatter)
    what = jnp.fft.rfftn(wi)
    psihat = what * jnp.asarray(inv_k2, what.dtype)
    psi = jnp.fft.irfftn(psihat, wi.shape).astype(u.dtype)
    out = jnp.zeros(g.N, u.dtype)
    return out.at[ip].set(psi)


def fieldobserver(setup, fieldname, *, psolver=None, logtol=None):
    """Jitted `state -> field` extractor at pressure DOFs (reference
    `observefield`, src/processors.jl:77-198). Supported names: component
    indices 0..D-1, 'velocity', 'velocitynorm', 'vorticity', 'pressure',
    'streamfunction', 'Dfield', 'Qfield', 'eig2field', 'temperature',
    'B1'.. / 'V1'.. tensor-basis channels."""
    import numpy as np

    from .ops._stencil import slc
    from .ops import operators as ops
    from .ops.pressure import default_psolver, pressure
    from .ops.tensorbasis import tensorbasis

    g = setup.grid
    D = g.dim
    ip = slc(g.Ip)
    if logtol is None:
        logtol = float(np.finfo(setup.dtype).eps)
    if fieldname in ("pressure", "Dfield") and psolver is None:
        psolver = default_psolver(setup)

    def compute(state):
        u, temp, t = state["u"], state["temp"], state["t"]
        if isinstance(fieldname, int):
            up = ops.interpolate_u_p(u, setup)
            return up[fieldname][ip]
        if fieldname == "velocity":
            up = ops.interpolate_u_p(u, setup)
            return up[(slice(None),) + ip]
        if fieldname == "velocitynorm":
            up = ops.interpolate_u_p(u, setup)
            return jnp.sqrt(sum(up[a] ** 2 for a in range(D)))[ip]
        if fieldname == "vorticity":
            w = ops.vorticity(u, setup)
            wp = ops.interpolate_omega_p(w, setup)
            return wp[ip] if D == 2 else wp[(slice(None),) + ip]
        if fieldname == "streamfunction":
            return get_streamfunction(u, setup)[ip]
        if fieldname == "pressure":
            p = pressure(u, temp, t, setup, psolver=psolver)
            return p[ip]
        if fieldname == "Dfield":
            p = pressure(u, temp, t, setup, psolver=psolver)
            d = ops.Dfield(p, setup)
            return jnp.log(jnp.maximum(logtol, d[ip]))
        if fieldname == "Qfield":
            q = ops.Qfield(u, setup)
            return jnp.log(jnp.maximum(logtol, q[ip]))
        if fieldname == "eig2field":
            lam = ops.eig2field(u, setup)
            return jnp.log(jnp.maximum(logtol, -lam[ip]))
        if fieldname == "temperature":
            return temp[ip]
        if isinstance(fieldname, str) and fieldname[0] in "BV":
            idx = int(fieldname[1:]) - 1
            B, V = tensorbasis(u, setup)
            if fieldname[0] == "B":
                return B[idx][ip]
            return V[idx][ip]
        raise ValueError(f"Unknown fieldname {fieldname!r}")

    return jax.jit(compute)


def observespectrum(setup, *, nupdate=1, npoint=100):
    """Processor recording the binned kinetic-energy spectrum
    (reference `observespectrum`, src/processors.jl:303-332). Returns
    dict(kappa, ehat_history)."""
    import numpy as np

    from .ops._stencil import slc
    from .utils.spectrum import spectral_stuff

    from .utils.spectrum import observe_spectrum

    g = setup.grid
    D = g.dim
    st = spectral_stuff(setup, npoint=npoint)
    K = st["K"]
    ip = slc(g.Ip)

    @jax.jit
    def ehat_of(u):
        e = 0.0
        for a in range(D):
            uhat = jnp.fft.fftn(u[a][ip])
            uhat = uhat[tuple(slice(0, k) for k in K)]
            e = e + jnp.abs(uhat) ** 2 / (2 * float(np.prod(g.Np)) ** 2)
        return observe_spectrum(e.astype(u.dtype), st)

    def initialize(state):
        return dict(kappa=np.asarray(st["kappa"]), ehat=[], t=[])

    def update(ps, state):
        ps["ehat"].append(np.asarray(ehat_of(state["u"])))
        ps["t"].append(float(state["t"]))
        return ps

    return Processor(initialize, update, lambda ps, s: ps, nupdate)


def save_vtk(state, *, setup, filename="output/solution",
             fieldnames=("velocity",), psolver=None):
    """Save a snapshot to a VTK file (reference save_vtk,
    src/processors.jl:248-258)."""
    import numpy as np

    from .ops._stencil import slc
    from .utils.vtk import write_vtr

    g = setup.grid
    coords = [np.asarray(g.xp[d])[slc(g.Ip)[d]] for d in range(g.dim)]
    data = {}
    for name in fieldnames:
        obs = fieldobserver(setup, name, psolver=psolver)
        data[str(name)] = np.asarray(obs(state))
    return write_vtr(filename, coords, data, time=float(state["t"]))


def vtk_writer(*, setup, nupdate=1, dir="output", filename="solution",
               fieldnames=("velocity",), psolver=None):
    """Processor writing time-stamped .vtr snapshots + a .pvd collection
    (reference vtk_writer, src/processors.jl:266-285)."""
    import os

    import numpy as np

    from .ops._stencil import slc
    from .utils.vtk import AsyncWriter, PVDCollection, write_vtr

    g = setup.grid
    coords = [np.asarray(g.xp[d])[slc(g.Ip)[d]] for d in range(g.dim)]
    observers = {
        str(name): fieldobserver(setup, name, psolver=psolver)
        for name in fieldnames
    }
    awriter = AsyncWriter()

    def initialize(state):
        os.makedirs(dir, exist_ok=True)
        pvd = PVDCollection(os.path.join(dir, filename))
        return _update(pvd, state)

    def _update(pvd, state):
        t = float(state["t"])
        tstr = f"{t:g}".replace(".", "p")
        data = {k: np.asarray(obs(state)) for k, obs in observers.items()}
        f = write_vtr(
            os.path.join(dir, f"{filename}_t={tstr}"), coords, data,
            time=t, writer=awriter,
        )
        pvd.add(t, f)
        return pvd

    def finalize(pvd, state):
        awriter.flush()
        return pvd.save()

    return Processor(initialize, _update, finalize, nupdate)


def jax_profiler(logdir="profile/jax_trace", *, start_n=0, stop_n=None,
                 nupdate=1):
    """Processor capturing a `jax.profiler` device trace of the run
    (SURVEY §5.1 — the reference has only a wall-clock `timelogger`,
    src/processors.jl:45-72; the profiler records per-op device
    timelines viewable in TensorBoard/XProf or Perfetto).

    Tracing starts at the first update with `state.n >= start_n` and stops
    at `state.n >= stop_n` (or at `finalize`). Because processors run at
    scan-chunk boundaries, the captured window snaps to chunk edges; keep
    `nupdate` small (it sets the chunk size) for a tight window."""

    def initialize(state):
        ps = {"on": False, "done": False, "dir": logdir}
        return _update(ps, state)

    def _update(ps, state):
        n = int(state["n"])
        if not ps["on"] and not ps["done"] and n >= start_n:
            import os

            os.makedirs(logdir, exist_ok=True)
            jax.profiler.start_trace(logdir)
            ps["on"] = True
        elif ps["on"] and stop_n is not None and n >= stop_n:
            jax.profiler.stop_trace()
            ps["on"] = False
            ps["done"] = True
        return ps

    def finalize(ps, state):
        if ps["on"]:
            jax.profiler.stop_trace()
            ps["on"] = False
            ps["done"] = True
        return ps

    return Processor(initialize, _update, finalize, nupdate)


def _interior_volume_weights(setup):
    """Cell-volume weights over the interior pressure box (for volume
    averages on stretched grids)."""
    from .ops._stencil import seg

    g = setup.grid
    w = jnp.ones(tuple(e - s for s, e in g.Ip), setup.dtype)
    for d in range(g.dim):
        w = w * seg(g.delta[d], g.Ip, d).astype(setup.dtype)
    return w


def observe_nusselt(setup, *, nupdate=1):
    """Processor recording the volume-averaged Nusselt number
    `Nu = 1 + <u_g θ> / α4` (convective heat transport over the conductive
    reference; the reference package has no Nusselt observable — this is a
    standard diagnostic for its RayleighBenard2D/3D examples,
    examples/RayleighBenard2D.jl:74-90). `gdir` and α4 come from
    `setup.temperature`."""
    from .ops._stencil import slc
    from .ops import operators as ops

    te = setup.temperature
    if te is None:
        raise ValueError("observe_nusselt requires a temperature equation")
    g = setup.grid
    ip = slc(g.Ip)
    w = _interior_volume_weights(setup)
    wsum = jnp.sum(w)
    a4 = te.alpha4
    gdir = te.gdir

    @jax.jit
    def nu_of(u, temp):
        up = ops.interpolate_u_p(u, setup)
        conv = jnp.sum(w * up[gdir][ip] * temp[ip]) / wsum
        return 1.0 + conv / a4

    def update(ps, state):
        ps["t"].append(float(state["t"]))
        ps["Nu"].append(float(nu_of(state["u"], state["temp"])))
        return ps

    def initialize(state):
        return update(dict(t=[], Nu=[]), state)

    return Processor(initialize, update, lambda ps, s: ps, nupdate)


def observe_wallshear(setup, *, dim, side, component, nupdate=1):
    """Processor recording the mean wall shear stress
    `τ_w = (1/Re) ∂u_c/∂x_d` (signed coordinate derivative) at a domain
    boundary (`dim`: wall-normal axis, `side`: 0 = low / 1 = high,
    `component`: tangential velocity index ≠ dim). Uses the ghost layer
    the BC fill maintains, so it is exact for the solver's own
    discretization. No reference counterpart (nearest: the examples
    eyeball plotted profiles)."""
    g = setup.grid
    D = g.dim
    if component == dim:
        raise ValueError("wall shear needs a tangential component")
    # Tangential components sit on pressure-centred positions along `dim`:
    # the first interior cell and the ghost cell straddle the wall.
    n = g.N[dim]
    if side == 0:
        i_in, i_gh = 1, 0
    else:
        i_in, i_gh = n - 2, n - 1
    # signed distance between the straddling sample points
    d_arr = np.asarray(g.xp[dim])
    dist = float(d_arr[i_in] - d_arr[i_gh])

    def plane(uc, idx):
        sl = [slice(1, -1)] * D
        sl[dim] = idx
        return uc[tuple(sl)]

    @jax.jit
    def shear_of(u):
        uc = u[component]
        du = (plane(uc, i_in) - plane(uc, i_gh)) / dist
        return jnp.mean(du) / setup.Re

    def update(ps, state):
        ps["t"].append(float(state["t"]))
        ps["tau"].append(float(shear_of(state["u"])))
        return ps

    def initialize(state):
        return update(dict(t=[], tau=[]), state)

    return Processor(initialize, update, lambda ps, s: ps, nupdate)
