"""Neural-closure end-to-end tests (mirrors reference
lib/NeuralClosure/test/examplerun.jl and filter.jl)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins
import ins_tpu.models as nc
from ins_tpu.time_steppers.rk_methods import RK44


def _setup(n, Re=2e3, dtype=jnp.float64):
    x = (np.linspace(0.0, 1.0, n + 1),) * 2
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 2
    return ins.Setup(x=x, boundary_conditions=bc, Re=Re, dtype=dtype)


def test_filters_preserve_constants():
    """Mirrors reference filter.jl:1-18."""
    dns = _setup(32)
    les = _setup(16)
    comp = 2
    u = jnp.ones((2, *dns.grid.N), dns.dtype)
    for phi in (nc.FaceAverage(), nc.VolumeAverage()):
        v = phi(u, les, comp)
        g = les.grid
        for a in range(2):
            sl = (a,) + tuple(slice(s, e) for (s, e) in g.Iu[a])
            np.testing.assert_allclose(np.asarray(v[sl]), 1.0, atol=1e-12)


def test_face_average_exact():
    """FaceAverage of a linear-in-x u-velocity is exact at coarse faces."""
    dns = _setup(32)
    les = _setup(16)
    comp = 2
    u = ins.velocityfield(
        dns, lambda d, x, y: (d == 0) * jnp.sin(2 * jnp.pi * x), doproject=False
    )
    v = nc.FaceAverage()(u, les, comp)
    # Coarse u-face values equal the mean over the fine faces at the same x
    g = les.grid
    assert not np.any(np.isnan(v))
    # The coarse face at x coincides with a fine face: along x no averaging
    # of positions happens for FaceAverage's normal component, only over y
    sl = (0,) + tuple(slice(s, e) for (s, e) in g.Iu[0])
    assert float(jnp.max(jnp.abs(v[sl]))) > 0.1


def test_reconstruct_roundtrip():
    dns = _setup(32)
    les = _setup(16)
    comp = 2
    v = ins.velocityfield(
        les,
        lambda d, x, y: (d == 0) * jnp.sin(2 * jnp.pi * x)
        + (d == 1) * jnp.cos(2 * jnp.pi * y),
        doproject=False,
    )
    u = nc.reconstruct(v, dns, les, comp)
    assert not np.any(np.isnan(u))
    # Filtering the reconstruction returns the LES field (FaceAverage is a
    # left inverse of linear reconstruction for face values)
    v2 = nc.FaceAverage()(ins.apply_bc_u(u, jnp.asarray(0.0), dns), les, comp)
    g = les.grid
    for a in range(2):
        sl = (a,) + tuple(slice(s, e) for (s, e) in g.Iu[a])
        np.testing.assert_allclose(
            np.asarray(v2[sl]), np.asarray(v[sl]), atol=5e-2
        )


@pytest.fixture(scope="module")
def les_data():
    rng = jax.random.PRNGKey(123)
    data = nc.create_les_data(
        D=2,
        Re=2e3,
        lims=(0.0, 1.0),
        nles=[16],
        ndns=32,
        filters=(nc.FaceAverage(), nc.VolumeAverage()),
        tburn=5e-3,
        tsim=2e-2,
        savefreq=2,
        dt=1e-3,
        rng=rng,
        dtype=jnp.float64,
        processors={},
    )
    return data


def test_create_les_data(les_data):
    assert len(les_data) == 2  # 1 LES grid x 2 filters
    for d in les_data:
        assert d["u"].shape[0] == d["c"].shape[0] == len(d["t"])
        assert d["u"].shape[0] >= 5
        assert not np.any(np.isnan(d["u"]))
        assert not np.any(np.isnan(d["c"]))


def test_apriori_and_aposteriori_training(les_data):
    les = _setup(16)
    io = nc.create_io_arrays(les_data, les)
    assert io["u"].shape[1:] == (16, 16, 2)

    rng = jax.random.PRNGKey(0)
    closure, theta0 = nc.cnn(
        setup=les,
        radii=[2, 2],
        channels=[8, 2],
        activations=[jax.nn.tanh, lambda x: x],
        use_bias=[True, False],
        rng=rng,
    )

    # ---- a-priori training (10 iters) ----
    dataloader = nc.create_dataloader_prior(
        (io["u"], io["c"]), batchsize=4
    )
    loss_prior = nc.create_loss_prior(closure)
    relerr_pri = nc.create_relerr_prior(
        closure, jnp.asarray(io["u"]), jnp.asarray(io["c"])
    )
    e0 = float(relerr_pri(theta0))
    ts = nc.create_trainstate(theta0, lr=1e-3, rng=jax.random.PRNGKey(7))
    cbstate, cb = nc.create_callback(relerr_pri, theta=theta0, nupdate=5)
    out = nc.train(
        dataloader=dataloader,
        loss=loss_prior,
        trainstate=ts,
        niter=10,
        callback=cb,
        callbackstate=cbstate,
    )
    e1 = float(relerr_pri(out["trainstate"]["theta"]))
    assert np.isfinite(e1)
    assert e1 <= e0 * 1.5  # training does not blow up

    # ---- a-posteriori training (3 iters, grad through solver) ----
    m = nc.wrappedclosure(closure, les)
    psolver = ins.psolver_spectral(les)
    loss_post = nc.create_loss_post(
        setup=les, method=RK44(), psolver=psolver, closure_model=m
    )
    traj = [dict(u=d["u"], t=d["t"]) for d in les_data]
    dl_post = nc.create_dataloader_post(traj, ntrajectory=2, nunroll=3)
    ts2 = nc.create_trainstate(
        out["trainstate"]["theta"], lr=1e-4, rng=jax.random.PRNGKey(8)
    )
    out2 = nc.train(
        dataloader=dl_post, loss=loss_post, trainstate=ts2, niter=3
    )
    theta2 = out2["trainstate"]["theta"]
    assert all(
        np.all(np.isfinite(np.asarray(v)))
        for v in jax.tree.leaves(theta2)
    )

    # ---- all four error types ----
    relerr_post = nc.create_relerr_post(
        data=dict(u=les_data[0]["u"][:4], t=les_data[0]["t"][:4]),
        setup=les,
        method=RK44(),
        psolver=psolver,
        closure_model=m,
    )
    e_post = float(relerr_post(theta2))
    assert np.isfinite(e_post)

    setup_c = ins.Setup(
        x=(np.linspace(0.0, 1.0, 17),) * 2,
        boundary_conditions=((ins.PeriodicBC(), ins.PeriodicBC()),) * 2,
        Re=2e3,
        closure_model=m,
        dtype=jnp.float64,
    )
    usym = jnp.asarray(les_data[0]["u"][:2])
    err_sym_pri = nc.create_relerr_symmetry_prior(u=usym, setup=setup_c)
    assert np.isfinite(float(err_sym_pri(theta2)))

    err_sym_post = nc.create_relerr_symmetry_post(
        u=jnp.asarray(les_data[0]["u"][0]),
        setup=setup_c,
        psolver=psolver,
        dt=1e-3,
        nstep=2,
    )
    assert np.isfinite(float(err_sym_post(theta2)))


def test_gcnn_equivariance():
    """The group CNN is exactly p4-equivariant
    (reference symmetry error machinery, training.jl:221-240)."""
    les = _setup(16)
    closure, theta = nc.gcnn(
        setup=les,
        radii=[2, 2],
        channels=[4, 1],
        activations=[jax.nn.tanh, lambda x: x],
        use_bias=[True, False],
        rng=jax.random.PRNGKey(1),
    )
    m = nc.wrappedclosure(closure, les)
    u = ins.random_field(les, kp=4, rng=jax.random.PRNGKey(2))
    for gidx in (1, 2, 3):
        cr = m(nc.rot2stag(u, gidx), theta)
        rc = nc.rot2stag(m(u, theta), gidx)
        sl = (slice(None),) + tuple(
            slice(s, e) for (s, e) in les.grid.Iu[0]
        )
        a = np.asarray(cr[sl])
        b = np.asarray(rc[sl])
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < 1e-6, (gidx, rel)


def test_fno_runs_and_trains():
    les = _setup(16)
    closure, theta = nc.fno(
        setup=les,
        kmax=[4, 4],
        c=[8, 8],
        sigma=[jax.nn.gelu, jax.nn.gelu],
        psi=jax.nn.gelu,
        rng=jax.random.PRNGKey(3),
    )
    x = jax.random.normal(jax.random.PRNGKey(4), (3, 16, 16, 2), jnp.float64)
    y = closure(x, theta)
    assert y.shape == x.shape
    assert not np.any(np.isnan(y))
    # One grad step
    loss = nc.create_loss_prior(closure)
    g = jax.grad(lambda th: loss((x, y * 0.9), th))(theta)
    assert all(np.all(np.isfinite(np.asarray(v))) for v in jax.tree.leaves(g))


def test_gaussian_force():
    setup = _setup(16)
    f = nc.gaussian_force(setup, rng=jax.random.PRNGKey(5))
    assert f.shape == (2, *setup.grid.N)
    assert abs(float(jnp.mean(f))) < 1e-12


def test_loss_post_remat_matches():
    """Checkpointed (remat) a-posteriori loss gives identical values and
    gradients to the plain unroll."""
    les = _setup(16)
    closure, theta = nc.cnn(
        setup=les, radii=[1], channels=[2],
        activations=[lambda x: x], use_bias=[False],
        rng=jax.random.PRNGKey(5),
    )
    m = nc.wrappedclosure(closure, les)
    ps = ins.psolver_spectral(les)
    u0 = ins.random_field(les, kp=3, rng=jax.random.PRNGKey(6))
    traj = [dict(
        u=jnp.stack([u0, u0 * 0.99, u0 * 0.98, u0 * 0.97]),
        t=jnp.arange(4, dtype=les.dtype) * 1e-2,
    )]
    l0 = nc.create_loss_post(setup=les, method=RK44(), psolver=ps, closure_model=m)
    l1 = nc.create_loss_post(setup=les, method=RK44(), psolver=ps, closure_model=m, remat=True)
    v0, g0 = jax.value_and_grad(lambda th: l0(traj, th))(theta)
    v1, g1 = jax.value_and_grad(lambda th: l1(traj, th))(theta)
    np.testing.assert_allclose(float(v0), float(v1), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)


def test_cnn_chunked_matches_direct():
    """Large-3D x-chunked CNN evaluation == the direct conv stack (the
    chunked path bounds XLA's channel-minor pad blowup; cnn.py module
    docstring)."""
    import ins_tpu as ins
    from ins_tpu.models import cnn
    from ins_tpu.models.cnn import CNN

    n = 64
    x = (np.linspace(0.0, 2 * np.pi, n + 1),) * 3
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    setup = ins.Setup(x=x, boundary_conditions=bc, Re=1e3,
                      dtype=jnp.float32)
    _, theta = cnn(
        setup=setup, radii=[2, 1], channels=[6, 3],
        activations=[jnp.tanh, lambda v: v], use_bias=[True, False],
        rng=jax.random.PRNGKey(0),
    )
    u = jax.random.normal(jax.random.PRNGKey(1), (2, n, n, n, 3),
                          jnp.float32)
    # f32 compute: XLA's CPU bf16 conv accumulates in bf16, so the
    # chunked/direct comparison would otherwise inherit lowering noise
    kw = dict(radii=(2, 1), channels=(6, 3),
              activations=(jnp.tanh, lambda v: v),
              use_bias=(True, False), dtype=jnp.float32,
              compute_dtype=jnp.float32)
    chunked = CNN(chunk_x=16, chunk_min_nx=n, **kw)
    direct = CNN(chunk_x=10**6, **kw)
    out_chunked = chunked.apply({"params": theta}, u)
    out_direct = direct.apply({"params": theta}, u)
    assert float(jnp.max(jnp.abs(out_chunked - out_direct))) < 1e-5


def test_cnn_fold_conv_matches_plain():
    """The tap-folded conv formulation (wider contraction;
    cnn.py module docstring) is algebraically identical to the plain
    circular conv — exact at f32 compute, ~bf16-rounded at bf16."""
    from ins_tpu.models.cnn import _DN, _fold_conv

    rng = jax.random.PRNGKey(2)
    for D, n in ((2, 24), (3, 12)):
        for r, cin, cout in ((1, 3, 8), (2, 3, 24), (2, 24, 24)):
            k1, k2, rng = jax.random.split(rng, 3)
            h = jax.random.normal(k1, (2,) + (n,) * D + (cin,), jnp.float32)
            w = 0.3 * jax.random.normal(
                k2, (2 * r + 1,) * D + (cin, cout), jnp.float32)
            pads = [(0, 0)] + [(r, r)] * D + [(0, 0)]
            ref = jax.lax.conv_general_dilated(
                jnp.pad(h, pads, mode="wrap"), w, (1,) * D, "VALID",
                dimension_numbers=_DN[D],
            )
            out32 = _fold_conv(h, w, r, (True,) * D, jnp.float32)
            # reassociation-only tolerance (values are O(10) sums of
            # ~3000 products); bf16 compute would differ by ~1e-1
            np.testing.assert_allclose(
                np.asarray(out32), np.asarray(ref), rtol=1e-4, atol=5e-5)
            outbf = _fold_conv(h, w, r, (True,) * D, jnp.bfloat16)
            scale = float(jnp.max(jnp.abs(ref)))
            assert float(jnp.max(jnp.abs(outbf - ref))) < 0.05 * scale
