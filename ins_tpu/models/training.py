"""Closure-model training: dataloaders, losses, metrics, train loop.

Re-design of IncompressibleNavierStokes.jl
`lib/NeuralClosure/src/training.jl` on optax. The a-posteriori loss
backpropagates through the unrolled differentiable solver (`timestep`),
with the self-adjoint Poisson custom-VJP keeping the FFT/CG internals out
of the tape. Loss+grad+update is one jitted function.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..setup import SetupData
from ..time_steppers.step import StepperState, timestep
from .groupconv import rot2stag

__all__ = [
    "create_dataloader_prior",
    "create_dataloader_post",
    "train",
    "trainepoch",
    "create_loss_prior",
    "create_relerr_prior",
    "create_loss_post",
    "create_relerr_post",
    "create_relerr_symmetry_prior",
    "create_relerr_symmetry_post",
    "create_callback",
    "create_trainstate",
]


def create_dataloader_prior(data, *, batchsize=50):
    """Random-batch dataloader over (x, y) arrays
    (reference training.jl:6-22). Returns `dataloader(rng) -> ((x, y), rng)`."""
    x, y = data

    def dataloader(rng):
        rng, k = jax.random.split(rng)
        i = jax.random.choice(
            k, x.shape[0], shape=(batchsize,), replace=False
        )
        i = np.sort(np.asarray(i))
        return (jnp.asarray(x[i]), jnp.asarray(y[i])), rng

    return dataloader


def create_dataloader_post(trajectories, *, ntrajectory, nunroll):
    """Trajectory dataloader for a-posteriori training
    (reference training.jl:27-39). Each batch: list of dicts (u, t) with
    `u` of shape (nunroll+1, D, *N)."""

    def dataloader(rng):
        rng, k1, k2 = jax.random.split(rng, 3)
        order = np.asarray(
            jax.random.permutation(k1, len(trajectories))
        )[:ntrajectory]
        batch = []
        starts = np.asarray(
            jax.random.randint(
                k2,
                (len(order),),
                0,
                max(1, min(len(trajectories[i]["t"]) for i in order) - nunroll),
            )
        )
        for j, i in enumerate(order):
            traj = trajectories[i]
            nt = len(traj["t"])
            assert nt > nunroll, f"Trajectory too short for nunroll={nunroll}"
            s = int(starts[j]) % (nt - nunroll)
            batch.append(
                dict(
                    u=jnp.asarray(traj["u"][s : s + nunroll + 1]),
                    t=jnp.asarray(traj["t"][s : s + nunroll + 1]),
                )
            )
        return batch, rng

    return dataloader


def create_trainstate(theta, *, opt=None, lr=1e-3, rng=None):
    """Bundle (optstate, theta, rng) for `train`."""
    if opt is None:
        opt = optax.adam(lr)
    if rng is None:
        rng = jax.random.PRNGKey(0)
    return dict(opt=opt, optstate=opt.init(theta), theta=theta, rng=rng)


def train(
    *,
    dataloader,
    loss,
    trainstate,
    niter,
    callback=None,
    callbackstate=None,
    lam=None,
):
    """SGD loop: grad of `loss(batch, theta)`, optional weight decay `lam`
    (reference train, training.jl:48-59)."""
    opt = trainstate["opt"]

    @jax.jit
    def step(theta, optstate, batch):
        l, g = jax.value_and_grad(lambda th: loss(batch, th))(theta)
        if lam is not None:
            g = jax.tree.map(lambda gi, ti: gi + lam * ti, g, theta)
        updates, optstate = opt.update(g, optstate, theta)
        theta = optax.apply_updates(theta, updates)
        return theta, optstate, l

    for _ in range(niter):
        batch, rng = dataloader(trainstate["rng"])
        theta, optstate, l = step(
            trainstate["theta"], trainstate["optstate"], batch
        )
        trainstate = dict(
            opt=opt, optstate=optstate, theta=theta, rng=rng
        )
        if callback is not None:
            callbackstate = callback(callbackstate, trainstate)
    return dict(trainstate=trainstate, callbackstate=callbackstate)


def trainepoch(
    *,
    data,
    batchsize,
    loss,
    trainstate,
    callback=None,
    callbackstate=None,
    noiselevel=None,
    lam=None,
):
    """One pass over the full (x, y) dataset in shuffled minibatches, with
    optional input noise injection (reference trainepoch,
    training.jl:68-101)."""
    x, y = data
    opt = trainstate["opt"]

    @jax.jit
    def step(theta, optstate, xb, yb):
        l, g = jax.value_and_grad(lambda th: loss((xb, yb), th))(theta)
        if lam is not None:
            g = jax.tree.map(lambda gi, ti: gi + lam * ti, g, theta)
        updates, optstate = opt.update(g, optstate, theta)
        theta = optax.apply_updates(theta, updates)
        return theta, optstate, l

    rng = trainstate["rng"]
    rng, k = jax.random.split(rng)
    order = np.asarray(jax.random.permutation(k, x.shape[0]))
    nbatch = x.shape[0] // batchsize
    theta, optstate = trainstate["theta"], trainstate["optstate"]
    for b in range(nbatch):
        i = np.sort(order[b * batchsize : (b + 1) * batchsize])
        xb = jnp.asarray(x[i])
        yb = jnp.asarray(y[i])
        if noiselevel is not None:
            rng, k = jax.random.split(rng)
            xb = xb + noiselevel * jax.random.normal(k, xb.shape, xb.dtype)
        theta, optstate, l = step(theta, optstate, xb, yb)
        trainstate = dict(opt=opt, optstate=optstate, theta=theta, rng=rng)
        if callback is not None:
            callbackstate = callback(callbackstate, trainstate)
    return dict(trainstate=trainstate, callbackstate=callbackstate)


def create_loss_prior(f):
    """Relative MSE a-priori loss (reference training.jl:104-106)."""

    def loss_prior(batch, theta):
        x, y = batch
        return jnp.sum((f(x, theta) - y) ** 2) / jnp.sum(y**2)

    return loss_prior


def create_relerr_prior(f, x, y):
    """A-priori relative error (reference training.jl:111)."""

    def relerr(theta):
        return jnp.linalg.norm(f(x, theta) - y) / jnp.linalg.norm(y)

    return jax.jit(relerr)


def _with_closure(setup, closure_model):
    return SetupData(
        grid=setup.grid,
        Re=setup.Re,
        temperature=setup.temperature,
        bodyforce_field=setup.bodyforce_field,
        boundary_conditions=setup.boundary_conditions,
        bodyforce=setup.bodyforce,
        issteadybodyforce=setup.issteadybodyforce,
        closure_model=closure_model,
        dtype=setup.dtype,
    )


def _unrolled_errors(
    u, t, theta, *, setup, method, psolver, nsubstep, sqrt_each, remat=False
):
    """Shared unroll: step the LES solver with closure from u[0] along the
    stored time stamps, accumulating relative errors on the DOF box.

    `remat=True` wraps each solver step in `jax.checkpoint`, trading
    recompute for activation memory — required for long unrolls
    (SURVEY.md §7 "grad-through-scan memory").

    When the setup qualifies for the ghost-free fast path, the unroll
    steps through `make_fast_timestep` (a roll graph that JAX
    differentiates natively) instead of the ghosted slice graph — where
    the reference hand-writes Enzyme adjoints for its hot kernels
    (src/operators.jl:1621-1910)."""
    from ..ops.fastpath import (
        fastpath_applicable,
        make_fast_timestep,
        strip_ghosts,
    )

    g = setup.grid
    inside = g.Iu[0]
    sl = (slice(None),) + tuple(slice(s, e) for (s, e) in inside)
    nt = u.shape[0]
    use_fast = fastpath_applicable(setup, method, psolver)
    if use_fast:
        fast_step = make_fast_timestep(setup, method)
        # interior-layout state: the ghosted DOF box shifts down by the
        # one-cell ghost border
        sl_state = (slice(None),) + tuple(
            slice(s - 1, e - 1) for (s, e) in inside
        )

        def one_step(state, dt, theta):
            return fast_step(state, dt, theta)

        ules = strip_ghosts(u[0])
    else:
        sl_state = sl

        def one_step(state, dt, theta):
            return timestep(
                method, state, dt, setup=setup, psolver=psolver, theta=theta
            )

        ules = u[0]
    state = StepperState(
        u=ules, temp=None, t=t[0], n=jnp.asarray(0)
    )

    if remat:
        one_step = jax.checkpoint(one_step)

    total = jnp.asarray(0.0, setup.dtype)
    for it in range(1, nt):
        dt = (t[it] - t[it - 1]) / nsubstep
        for _ in range(nsubstep):
            state = one_step(state, dt, theta)
        a = jnp.sum((state.u[sl_state] - u[it][sl]) ** 2)
        b = jnp.sum(u[it][sl] ** 2)
        total = total + (jnp.sqrt(a / b) if sqrt_each else a / b)
    return total / (nt - 1)


def create_loss_post(
    *, setup, method, psolver, closure_model, nsubstep=1, remat=False
):
    """A-posteriori loss: relative trajectory error of the unrolled
    differentiable solver (reference training.jl:116-141). `remat=True`
    checkpoints each step (long unrolls)."""
    setup_c = _with_closure(setup, closure_model)

    def loss_post(data, theta):
        total = 0.0
        for traj in data:
            total = total + _unrolled_errors(
                traj["u"],
                traj["t"],
                theta,
                setup=setup_c,
                method=method,
                psolver=psolver,
                nsubstep=nsubstep,
                sqrt_each=False,
                remat=remat,
            )
        return total / len(data)

    return loss_post


def create_relerr_post(*, data, setup, method, psolver, closure_model, nsubstep=1):
    """A-posteriori relative error (reference training.jl:146-173)."""
    setup_c = _with_closure(setup, closure_model)
    u = jnp.asarray(data["u"])
    t = jnp.asarray(data["t"])

    @jax.jit
    def relerr_post(theta):
        return _unrolled_errors(
            u,
            t,
            theta,
            setup=setup_c,
            method=method,
            psolver=psolver,
            nsubstep=nsubstep,
            sqrt_each=True,
        )

    return relerr_post


def create_relerr_symmetry_prior(*, u, setup, g=1):
    """A-priori rotation-equivariance error of the closure
    (reference training.jl:221-240). `u`: (nsample, D, *N) ghosted fields."""
    closure = setup.closure_model
    inside = setup.grid.Iu[0]
    sl = (slice(None),) + tuple(slice(s, e) for (s, e) in inside)

    def err(theta):
        total = 0.0
        for i in range(u.shape[0]):
            ui = u[i]
            cr = closure(rot2stag(ui, g), theta)
            rc = rot2stag(closure(ui, theta), g)
            a = jnp.sum((rc[sl] - cr[sl]) ** 2)
            b = jnp.sum(cr[sl] ** 2)
            total = total + jnp.sqrt(a / b)
        return total / u.shape[0]

    return jax.jit(err)


def create_relerr_symmetry_post(
    *, u, setup, psolver, method=None, dt, nstep, g=1
):
    """A-posteriori symmetry error: rotate-then-solve vs solve-then-rotate
    (reference training.jl:178-216)."""
    from ..time_steppers.rk_methods import RK44

    if method is None:
        method = RK44()
    inside = setup.grid.Iu[0]
    sl = (slice(None),) + tuple(slice(s, e) for (s, e) in inside)
    dtj = jnp.asarray(dt, setup.dtype)

    @jax.jit
    def err(theta):
        s1 = StepperState(u=u, temp=None, t=jnp.asarray(0.0, setup.dtype), n=jnp.asarray(0))
        s2 = StepperState(
            u=rot2stag(u, g), temp=None, t=jnp.asarray(0.0, setup.dtype), n=jnp.asarray(0)
        )
        total = jnp.asarray(0.0, setup.dtype)
        for _ in range(nstep):
            s1 = timestep(method, s1, dtj, setup=setup, psolver=psolver, theta=theta)
            s2 = timestep(method, s2, dtj, setup=setup, psolver=psolver, theta=theta)
            u_rot = rot2stag(s1.u, g)
            a = jnp.sum((s2.u[sl] - u_rot[sl]) ** 2)
            b = jnp.sum(u_rot[sl] ** 2)
            total = total + jnp.sqrt(a / b)
        return total / nstep

    return err


def create_callback(err, *, theta, nupdate=1, displayupdates=False):
    """Track the best parameters and error history
    (reference create_callback, training.jl:251-305, minus Makie)."""
    state = dict(
        n=0,
        theta_min=theta,
        emin=float("inf"),
        hist=[],
        ctime=time.time(),
    )

    def callback(callbackstate, trainstate):
        cs = dict(callbackstate)
        if cs["n"] % nupdate == 0:
            e = float(err(trainstate["theta"]))
            now = time.time()
            itertime = (now - cs["ctime"]) / max(1, nupdate)
            cs["ctime"] = now
            print(
                f"Iteration {cs['n']}\trelative error: {e:.4g}"
                f"\tsec/iter: {itertime:.4g}"
            )
            cs["hist"] = cs["hist"] + [(cs["n"], e)]
            if e < cs["emin"]:
                cs["theta_min"] = trainstate["theta"]
                cs["emin"] = e
        cs["n"] += 1
        return cs

    return state, callback
