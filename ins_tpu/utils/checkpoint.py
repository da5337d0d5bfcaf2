"""Checkpoint / resume for solver and training state.

The reference has no solver checkpointing (SURVEY.md §5.4); this is a new
first-class component: any pytree of arrays (velocity, temperature, time,
RNG keys, closure parameters, optimizer state) round-trips through a
single numpy `.npz` file holding the flattened leaves and the tree
structure, which `load_checkpoint` checks against the caller's template.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "checkpointer",
    "async_checkpointer",
    "load_async_checkpoint",
]

_TREEDEF_KEY = "__treedef__"


def save_checkpoint(path, tree):
    """Serialize a pytree of arrays to `path` (numpy `.npz` layout; the
    name is used as given)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, treedef = jax.tree.flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    arrays[_TREEDEF_KEY] = np.asarray(str(treedef))
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def load_checkpoint(path, like):
    """Load a pytree saved by `save_checkpoint`; `like` provides the
    structure (same pytree with arbitrary array values), which must match
    the saved one."""
    treedef = jax.tree.structure(like)
    with np.load(path, allow_pickle=False) as data:
        saved = str(data[_TREEDEF_KEY])
        if saved != str(treedef):
            raise ValueError(
                f"checkpoint structure {saved} does not match {treedef}"
            )
        leaves = [
            jnp.asarray(data[f"leaf_{i}"]) for i in range(treedef.num_leaves)
        ]
    return jax.tree.unflatten(treedef, leaves)


def checkpointer(path, *, nupdate=1, keep_last=1):
    """Processor that checkpoints (u, temp, t, n) every `nupdate` steps.

    Resume manually: `ckpt = load_checkpoint(file, like)` then pass
    `ustart=ckpt["u"], tempstart=ckpt["temp"]` and shifted `tlims` to
    `solve_unsteady` (the reference's manual-resume pattern,
    lib/NeuralClosure/src/data_generation.jl:194-198, made durable).
    """
    from ..processors import Processor

    saved = []

    def initialize(state):
        return saved

    def update(saved, state):
        n = int(state["n"])
        file = os.path.join(path, f"state_{n:08d}.npz")
        save_checkpoint(
            file,
            dict(
                u=state["u"],
                temp=state["temp"],
                t=state["t"],
                n=state["n"],
            ),
        )
        saved.append(file)
        while len(saved) > keep_last:
            old = saved.pop(0)
            if os.path.exists(old):
                os.remove(old)
        return saved

    p = Processor(initialize, update, lambda s, _: s, nupdate)
    p.ckpt_path = path  # solver NaN guard writes its emergency file here
    return p


def async_checkpointer(path, *, nupdate=1, keep_last=2):
    """Non-blocking checkpoint processor backed by Orbax's async
    CheckpointManager: device->host transfer happens at the update, the
    filesystem write runs in a background thread, so the solver's scan
    chunks are never blocked on IO (pod-scale runs: orbax handles
    multi-host coordination and sharded arrays natively).

    Retention: `keep_last` checkpoints, managed by orbax.  Resume with
    `load_async_checkpoint(path, like)` (latest step).
    """
    import orbax.checkpoint as ocp

    from ..processors import Processor

    mngr = ocp.CheckpointManager(
        os.path.abspath(path),
        options=ocp.CheckpointManagerOptions(
            max_to_keep=keep_last, enable_async_checkpointing=True
        ),
    )

    def initialize(state):
        return mngr

    def update(mngr, state):
        payload = dict(u=state["u"], t=state["t"], n=state["n"])
        if state.get("temp") is not None:
            payload["temp"] = state["temp"]
        mngr.save(int(state["n"]), args=ocp.args.StandardSave(payload))
        return mngr

    def finalize(mngr, state):
        mngr.wait_until_finished()
        return mngr

    p = Processor(initialize, update, finalize, nupdate)
    p.ckpt_path = path
    return p


def load_async_checkpoint(path, like=None, step=None):
    """Load the latest (or given) step written by `async_checkpointer`.

    `like`: optional pytree providing structure and dtype.  Leaves that
    are `jax.Array`s (or `jax.ShapeDtypeStruct`s carrying a `.sharding`)
    restore WITH that sharding — orbax reads each host's shards directly,
    so a pod-sharded state reloads without gathering the full array per
    host.  Plain numpy/host leaves restore single-host onto the default
    device (the small-run path)."""
    import orbax.checkpoint as ocp

    mngr = ocp.CheckpointManager(os.path.abspath(path))
    if step is None:
        step = mngr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no orbax checkpoints under {path}")
    if like is None:
        restored = mngr.restore(step)
    else:

        def _target(x):
            # keep shardings: hand orbax an abstract leaf, not a host copy
            if isinstance(x, jax.Array):
                return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding)
            if isinstance(x, jax.ShapeDtypeStruct):
                return x
            return np.asarray(x)

        restored = mngr.restore(
            step, args=ocp.args.StandardRestore(jax.tree.map(_target, like))
        )
    return jax.tree.map(
        lambda x: x if isinstance(x, jax.Array) else jnp.asarray(x),
        dict(restored),
    )
