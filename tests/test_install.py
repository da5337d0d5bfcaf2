"""Installation surface: the compile-cache placement, `import ins_tpu`
and the fast path without the optional packages, numpy checkpoints, and
`chip_smoke.py` refusing to run without a GPU."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins
from ins_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, cwd=REPO, args=None):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    cmd = [sys.executable] + (args if args is not None else ["-c", code])
    return subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    d = compile_cache.enable_compile_cache()
    assert d == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", d)]
    assert compile_cache.enable_compile_cache() == d  # stable


def test_compile_cache_env_wins_in_process(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    compile_cache.enable_compile_cache()
    assert calls == []  # sets no other directory


def test_compile_cache_env_wins_in_fresh_process(tmp_path):
    out = _run(
        "import jax\n"
        "from ins_tpu.utils.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n",
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


_BLOCK = textwrap.dedent(
    """
    import importlib.abc, sys

    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("flax", "orbax", "matplotlib"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, _Block())
    """
)


def test_import_and_fast_path_without_optional_packages():
    out = _run(
        _BLOCK
        + textwrap.dedent(
            """
            import jax, jax.numpy as jnp, numpy as np
            import ins_tpu as ins
            x = (np.linspace(0, 2 * np.pi, 9),) * 2
            bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 2
            setup = ins.Setup(x=x, boundary_conditions=bc, dtype=jnp.float32)
            u0 = ins.random_field(setup, kp=2, rng=jax.random.PRNGKey(0))
            s, _ = ins.solve_unsteady(setup=setup, ustart=u0,
                                      tlims=(0.0, 2e-3), dt=1e-3)
            assert bool(jnp.all(jnp.isfinite(s.u)))
            blocked = [m for m in sys.modules
                       if m.split(".")[0] in ("flax", "orbax", "matplotlib")]
            assert not blocked, blocked
            print("ok")
            """
        )
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


TREES = {
    "solver_state": lambda: dict(
        u=jnp.arange(24.0).reshape(2, 3, 4), temp=None,
        t=jnp.asarray(0.25), n=jnp.asarray(7),
    ),
    "with_temp": lambda: dict(
        u=jnp.ones((2, 4, 4), jnp.float32), temp=jnp.zeros((4, 4)),
        t=jnp.asarray(1.5, jnp.float32), n=jnp.asarray(3, jnp.int32),
    ),
    "nested": lambda: dict(
        params=[dict(w=jnp.eye(3), b=jnp.zeros(3)), (jnp.ones(2),)],
        key=jax.random.PRNGKey(5),
        step=jnp.asarray(11),
    ),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_checkpoint_roundtrip_npz(name, tmp_path):
    tree = TREES[name]()
    path = str(tmp_path / "sub" / "ckpt.bin")
    assert ins.save_checkpoint(path, tree) == path
    assert os.path.exists(path)  # the name is used as given
    like = jax.tree.map(jnp.zeros_like, tree)
    back = ins.load_checkpoint(path, like)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    ins.save_checkpoint(path, dict(u=jnp.ones(3), t=jnp.asarray(0.0)))
    with pytest.raises(ValueError, match="structure"):
        ins.load_checkpoint(path, dict(u=jnp.ones(3), temp=jnp.ones(3)))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """No GPU (or no repository beside it): non-zero exit, no result."""
    cwd = REPO
    if where == "alone":
        import shutil

        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = _run(None, cwd=cwd, args=["chip_smoke.py"],
               env_extra={"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
