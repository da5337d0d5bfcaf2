"""Unsteady solver driver.

Re-design of IncompressibleNavierStokes.jl `src/solver.jl`. The hot loop is
a jitted `lax.scan` over chunks of steps; processors (observability/I-O)
run host-side between chunks, at their `nupdate` decimation — the
accelerator-side equivalent of the reference's per-step Observable updates
(src/solver.jl:49-88). Adaptive time stepping (CFL) runs the step in a
host-driven loop with a jitted CFL estimator (src/solver.jl:101-125).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .ops._stencil import seg, slc
from .ops.pressure import default_psolver
from .time_steppers.methods import ExplicitRungeKuttaMethod
from .time_steppers.rk_methods import RK44
from .time_steppers.step import StepperState, create_stepper, timestep

__all__ = [
    "solve_unsteady",
    "get_cfl_timestep",
    "get_state",
    "SolverDivergedError",
]


class SolverDivergedError(RuntimeError):
    """A run produced non-finite fields (SURVEY §5.3 failure detection).

    Carries the last finite state (`state`, a dict like `get_state`'s) so
    the caller can inspect or resume from it, and `checkpoint` — the path
    of the emergency checkpoint written when a `checkpointer` processor
    was attached (SURVEY §5.4 wiring)."""

    def __init__(self, msg, state=None, checkpoint=None):
        super().__init__(msg)
        self.state = state
        self.checkpoint = checkpoint


def get_state(stepper: StepperState):
    return dict(u=stepper.u, temp=stepper.temp, t=stepper.t, n=stepper.n)


def get_cfl_timestep(u, setup):
    """Maximum stable time step from convection and diffusion limits
    (reference src/solver.jl:101-125)."""
    g = setup.grid
    dt = jnp.asarray(jnp.inf, setup.dtype)
    for a in range(g.dim):
        s, e = g.Iu[a][a]
        d_min = jnp.min(g.delta_u[a][s:e])
        dt_diff = setup.Re * d_min**2 / 2
        box = g.Iu[a]
        da = seg(g.delta_u[a], box, a)
        dt_conv = jnp.min(da / jnp.abs(u[(a,) + slc(box)]))
        dt = jnp.minimum(dt, jnp.minimum(dt_diff, dt_conv))
    return dt


def _chunk_sizes(nstep: int, chunk: int):
    out = []
    left = nstep
    while left > 0:
        c = min(chunk, left)
        out.append(c)
        left -= c
    return out


# Compiled step/scan cache: repeated solve_unsteady calls with the same
# (setup, method, psolver) reuse the jitted functions instead of
# re-tracing fresh closures. Values keep strong refs to the keys' objects
# so ids stay valid.
_compiled_cache: dict = {}


def _get_compiled(setup, method, psolver, theta_is_none, builder, extra=()):
    key = (id(setup), id(psolver), method, theta_is_none) + tuple(extra)
    hit = _compiled_cache.get(key)
    if hit is not None:
        return hit[0]
    fns = builder()
    _compiled_cache[key] = (fns, setup, psolver)
    if len(_compiled_cache) > 64:
        _compiled_cache.pop(next(iter(_compiled_cache)))
    return fns


def solve_unsteady(
    *,
    setup,
    ustart,
    tlims,
    tempstart=None,
    method=None,
    psolver=None,
    dt=None,
    dt_min=None,
    cfl=0.9,
    n_adapt_dt=1,
    processors=None,
    theta=None,
    docopy=True,
    max_chunk=256,
    mesh=None,
    halo=False,
    halo_psolver="pencil",
    nan_guard=True,
):
    """Solve the unsteady problem on `tlims`.

    Fixed `dt`: it is rounded so `(tend - tstart)/dt` is an integer and the
    loop runs as jitted scan chunks. `dt=None`: adaptive CFL-based stepping.
    `processors` is a dict name -> Processor; returns `(state, outputs)`.

    `mesh`: optional `jax.sharding.Mesh` for multi-chip domain
    decomposition — the state is placed with spatial sharding and XLA
    GSPMD inserts the halo exchanges / FFT transposes (the reference is
    single-device; SURVEY.md §2.5).

    `halo=True` (requires `mesh`): step with the explicitly-scheduled
    shard_map path instead of GSPMD — ppermute halo exchanges, the
    per-shard roll graph, an all_to_all'd pencil FFT or psum'd CG
    pressure solve (`parallel/halo.py`), with the full driver feature
    set (processors, NaN guard, checkpointing, adaptive CFL — whose
    min-reductions GSPMD lowers to psums over the mesh).  3D uniform
    periodic only; `halo_psolver`: "pencil" (FFT) or "cg".

    `nan_guard`: one cheap `isfinite` reduction per scan chunk (SURVEY
    §5.3). On divergence the run aborts with `SolverDivergedError`
    carrying the last finite state; if a `checkpointer` processor is
    attached, an emergency checkpoint of that state is written first.
    """
    if method is None:
        method = RK44()
    if psolver is None:
        psolver = default_psolver(setup)
    processors = dict(processors or {})
    if halo and mesh is None:
        raise ValueError("halo=True requires a mesh")

    if docopy:
        # The scan donates state buffers; keep the caller's arrays intact
        # (reference `docopy`, src/solver.jl:29,35-36).
        ustart = jnp.copy(ustart)
        if tempstart is not None:
            tempstart = jnp.copy(tempstart)

    if mesh is not None and not halo:
        from .parallel.mesh import shard_state

        ustart, tempstart = shard_state(mesh, ustart, tempstart)

    tstart, tend = tlims

    def _builder():
        from .ops.fastpath import (
            fastpath_applicable,
            make_fast_timestep,
            reghost,
            reghost_state,
            strip_state,
        )

        use_fast = not halo and fastpath_applicable(setup, method, psolver)
        # Wall-bounded (channel-topology) fast path: engaged when the
        # chosen psolver is the FDM direct solve (the channel path's
        # projection IS that solve, so the user's solver semantics are
        # preserved; pass psolver_cg to force the general stepper).
        use_channel = False
        if not (halo or use_fast) and getattr(psolver, "is_fdm", False):
            from .ops.channelpath import channelpath_applicable

            use_channel = channelpath_applicable(setup, method)
        if halo:
            from .parallel.halo import make_halo_fast_step

            # un-jitted shard_map body: traced inside the driver's own
            # jit/scan (nested donation is dropped by jit-of-jit)
            step = make_halo_fast_step(
                setup, method, mesh, psolver=halo_psolver
            ).raw

            strip = jax.jit(strip_state)
            regh_state = jax.jit(reghost_state)
            regh = jax.jit(reghost)
        elif use_fast:
            step = make_fast_timestep(setup, method)

            strip = jax.jit(strip_state)
            regh_state = jax.jit(reghost_state)
            regh = jax.jit(reghost)
        elif use_channel:
            from .ops.channelpath import (
                make_channel_timestep,
                reghost_channel,
                strip_channel,
            )

            step = make_channel_timestep(setup, method)

            strip = jax.jit(lambda s: s._replace(u=strip_channel(s.u)))
            regh_state = jax.jit(
                lambda s: s._replace(u=reghost_channel(s.u, setup))
            )
            regh = jax.jit(lambda u: reghost_channel(u, setup))
        else:

            def step(s, dtj, th):
                return timestep(
                    method, s, dtj, setup=setup, psolver=psolver, theta=th
                )

            strip = regh = regh_state = None

        # One jit for stepper creation: AB-CN/one-leg initialization
        # includes a pressure solve
        make_stepper = jax.jit(
            lambda u, temp, t0: create_stepper(
                method, setup=setup, psolver=psolver, u=u, temp=temp, t=t0
            )
        )
        step1 = jax.jit(step, donate_argnums=(0,))

        @partial(jax.jit, static_argnums=(3,), donate_argnums=(0,))
        def scan_steps(s, dtj, th, nsteps):
            def body(si, _):
                return step(si, dtj, th), None

            s, _ = jax.lax.scan(body, s, None, length=nsteps)
            return s

        def cfl_u(s):
            interior = use_fast or halo or use_channel
            return get_cfl_timestep(regh(s.u) if interior else s.u, setup)

        # Adaptive stepping fully on-device: a `lax.while_loop` advances up
        # to `max_steps` steps (or until `tend`), recomputing the CFL dt
        # every `n_adapt` steps — no per-step host sync (the reference's
        # loop is host-driven, src/solver.jl:53-80; so was round 1's).
        # `cfl_j`/`dt_min_j` are traced so changing them doesn't recompile.
        @partial(jax.jit, static_argnums=(6, 7), donate_argnums=(0,))
        def scan_adaptive(s, dt_cur, cfl_j, dt_min_j, tend_j, th, max_steps, n_adapt):
            tdt = s.t.dtype
            margin = jnp.asarray(1e-14, tdt) * jnp.maximum(
                jnp.asarray(1.0, tdt), jnp.abs(tend_j)
            )
            # The CFL estimate is under a `lax.cond`, so it only runs
            # on the steps that recompute dt (every n_adapt steps).

            def cond(carry):
                si, dtc, k = carry
                return jnp.logical_and(k < max_steps, si.t < tend_j - margin)

            def body(carry):
                si, dtc, k = carry
                dtc = jax.lax.cond(
                    si.n % n_adapt == 0,
                    lambda s2, d: (cfl_j * cfl_u(s2)).astype(
                        d.dtype
                    ),
                    lambda s2, d: d,
                    si, dtc,
                )
                dtc = jnp.maximum(dtc, dt_min_j)
                dt_step = jnp.minimum(dtc, tend_j - si.t).astype(tdt)
                return (step(si, dt_step, th), dtc, k + 1)

            si, dtc, _ = jax.lax.while_loop(
                cond, body, (s, dt_cur, jnp.asarray(0, jnp.int32))
            )
            return si, dtc

        return dict(
            use_fast=use_fast,
            use_halo=halo,
            use_channel=use_channel,
            strip=strip,
            regh=regh,
            regh_state=regh_state,
            make_stepper=make_stepper,
            step1=step1,
            scan_steps=scan_steps,
            scan_adaptive=scan_adaptive,
            cfl_fn=jax.jit(cfl_u),
        )

    fns = _get_compiled(
        setup, method, psolver, theta is None, _builder,
        extra=(halo, halo_psolver if halo else None,
               id(mesh) if halo else None),
    )
    state = fns["make_stepper"](
        ustart, tempstart, jnp.asarray(tstart, setup.dtype)
    )
    if fns["use_fast"] or fns["use_halo"] or fns["use_channel"]:
        state = fns["strip"](state)
        if fns["use_halo"]:
            from .parallel.halo import shard_interior, shard_scalar

            state = state._replace(u=shard_interior(mesh, state.u))
            if state.temp is not None:
                state = state._replace(temp=shard_scalar(mesh, state.temp))

        def to_public(s):
            return fns["regh_state"](s)

    else:

        def to_public(s):
            return s

    initialized = {
        k: p.initialize(get_state(to_public(state)))
        for k, p in processors.items()
    }

    def _update_processors(state):
        st = None
        n = int(state.n)
        for k, p in processors.items():
            if n % getattr(p, "nupdate", 1) == 0:
                if st is None:
                    st = get_state(to_public(state))
                initialized[k] = p.update(initialized[k], st)

    def _diverged(last_good):
        """Abort on non-finite fields: emergency-checkpoint the last
        finite state (if a checkpointer is attached) and raise."""
        from .utils.checkpoint import save_checkpoint

        st = get_state(to_public(last_good)) if last_good is not None else None
        ckpt = None
        for p in processors.values():
            path = getattr(p, "ckpt_path", None)
            if path is not None and st is not None:
                import os

                ckpt = os.path.join(path, "state_diverged_last_good.npz")
                save_checkpoint(
                    ckpt,
                    dict(u=st["u"], temp=st["temp"], t=st["t"], n=st["n"]),
                )
                break
        at = "" if st is None else f" (last finite state: n={int(st['n'])}, t={float(st['t']):g})"
        raise SolverDivergedError(
            f"solver produced non-finite fields{at}", state=st, checkpoint=ckpt
        )

    def _finite(s):
        ok = bool(jnp.all(jnp.isfinite(s.u)))
        if ok and s.temp is not None:
            ok = bool(jnp.all(jnp.isfinite(s.temp)))
        return ok

    def _keep(s):
        # last-good copy (donated scans consume every current buffer)
        return jax.tree.map(jnp.copy, s)

    isadaptive = dt is None
    if isadaptive:
        # Chunked on-device adaptive loop: each host iteration runs one
        # jitted while_loop of `chunk` steps; processors (and the NaN
        # guard) flush between chunks at their `nupdate` decimation.
        nupdates = [getattr(p, "nupdate", 1) for p in processors.values()]
        chunk = math.gcd(*nupdates) if nupdates else max_chunk
        chunk = max(1, min(chunk, max_chunk))
        n_adapt = max(int(n_adapt_dt), 1)
        cfl_j = jnp.asarray(cfl, setup.dtype)
        dt_min_j = jnp.asarray(0.0 if dt_min is None else dt_min, setup.dtype)
        tend_j = jnp.asarray(tend, setup.dtype)
        # Seed dt for states entering with n % n_adapt != 0 (e.g. resume)
        dt_cur = jnp.maximum(cfl_j * fns["cfl_fn"](state), dt_min_j)
        last_good = _keep(state) if nan_guard else None
        while float(state.t) < tend - 1e-14 * max(1.0, abs(tend)):
            n_prev = int(state.n)
            state, dt_cur = fns["scan_adaptive"](
                state, dt_cur, cfl_j, dt_min_j, tend_j, theta, chunk, n_adapt
            )
            if int(state.n) == n_prev:
                ulp = float(np.finfo(np.dtype(setup.dtype)).eps) * max(
                    1.0, abs(tend)
                )
                if abs(tend - float(state.t)) <= 4 * ulp:
                    break  # reached tend to dtype resolution
                # dt underflowed to 0 away from tend (degenerate CFL
                # estimate): cannot make progress.
                raise SolverDivergedError(
                    f"adaptive dt underflow at t={float(state.t):g} "
                    f"(dt={float(dt_cur):g})",
                    state=get_state(to_public(state)),
                )
            if nan_guard:
                if not (_finite(state) and bool(jnp.isfinite(state.t))):
                    _diverged(last_good)
                last_good = _keep(state)
            _update_processors(state)
    else:
        nstep = int(round((tend - tstart) / dt))
        dt = (tend - tstart) / nstep
        dtj = jnp.asarray(dt, setup.dtype)

        nupdates = [getattr(p, "nupdate", 1) for p in processors.values()]
        chunk = math.gcd(*nupdates) if nupdates else max_chunk
        chunk = max(1, min(chunk, max_chunk, nstep))

        # Scan in `chunk`-step bursts; processors flush between bursts
        # (chunk = gcd of processor nupdates, so decimation is honored).
        last_good = _keep(state) if nan_guard else None
        for c in _chunk_sizes(nstep, chunk):
            state = fns["scan_steps"](state, dtj, theta, c)
            if nan_guard:
                if not _finite(state):
                    _diverged(last_good)
                last_good = _keep(state)
            if processors:
                _update_processors(state)

    state = to_public(state)
    outputs = {
        k: p.finalize(initialized[k], get_state(state))
        for k, p in processors.items()
    }
    return state, outputs
