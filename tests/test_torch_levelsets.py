"""Port parity: ``image/levelsets.py``.

The same float32 level-set functions (seeded or analytic NumPy arrays, cast
explicitly: the suite's conftest turns on JAX x64) go through the JAX
functions and the port's on the CPU. Tolerances, in absolute terms:

- fast sweeping, signed distance and reinitialization: within 1e-4;
- a 20-step ``NarrowBand`` run: within 1e-4, with the same number of
  reinitialisations (the twin's are counted by wrapping its module's
  ``reinitialize_signed_distance``; its constructor's call is one more);
- one evaluation of a flux, a WENO3 derivative or an integrator step:
  within 1e-5 (XLA and torch round the same float32 formulas in another
  order of fusion);
- the long evolutions (hundreds of steps with reinitialisations): the
  analytic gate of the twin's test on the port, and the port's measured
  front radius within 1e-3 px of the twin's.

The cases are the twins of ``tests/test_levelsets.py`` and of the fast
sweeping and signed-distance cases of ``tests/test_image_advanced.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sara_tpu.image import levelsets as jl
from sara_tpu_torch.image import levelsets as tl


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a sweep is thousands of row-sized operations,
    and the suite runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def circle_np(n, cx, cy, r):
    y, x = np.mgrid[0:n, 0:n]
    return (np.hypot(x - cx, y - cy) - r).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(port, ref, tol):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    err = float(np.abs(np.asarray(port, np.float64)
                       - np.asarray(ref, np.float64)).max())
    assert err <= tol, err


def front_radius(phi, cx, cy, mod):
    """Mean distance of zero-crossing cells from the center, sub-cell
    corrected by phi, with ``mod``'s zero-crossing mask."""
    if mod is tl:
        m = tl._zero_crossing_mask(phi).numpy()
        p = phi.numpy()
    else:
        m = np.asarray(jl._zero_crossing_mask(phi))
        p = np.asarray(phi)
    y, x = np.nonzero(m)
    return float((np.hypot(x - cx, y - cy) - p[y, x]).mean())


# --- fast sweeping and signed distance --------------------------------------

def test_fast_sweeping_distance():
    seed = np.zeros((64, 64), bool)
    seed[32, 32] = True
    d = tl.fast_sweeping_distance(t(seed))
    close(d, jl.fast_sweeping_distance(jnp.asarray(seed)), 1e-4)
    d = d.numpy()
    assert abs(d[32, 32]) < 1e-6
    assert abs(d[32, 42] - 10.0) < 1.0
    assert abs(d[42, 32] - 10.0) < 1.0
    assert abs(d[40, 40] - np.sqrt(128)) < 2.0


def test_fast_sweeping_matches_euclidean_distance():
    n = 64
    seed = np.zeros((n, n), bool)
    seed[32, 32] = True
    d = tl.fast_sweeping_distance(t(seed), num_sweeps=4)
    close(d, jl.fast_sweeping_distance(jnp.asarray(seed), num_sweeps=4),
          1e-4)
    y, x = np.mgrid[0:n, 0:n]
    true = np.hypot(x - 32, y - 32)
    sel = true < 20
    assert np.max(np.abs(d.numpy()[sel] - true[sel])) < 1.2


@pytest.mark.parametrize("sweeps", [1, 2, 4])
def test_fast_sweeping_with_speed_and_seed_values(sweeps):
    """Seeded scattered seeds with their own initial values, a varying
    slowness and a non-square grid."""
    rs = np.random.RandomState(sweeps)
    seed = rs.rand(48, 80) > 0.995
    speed = rs.uniform(0.5, 2.0, (48, 80)).astype(np.float32)
    sv = rs.uniform(0.0, 0.5, (48, 80)).astype(np.float32)
    got = tl.fast_sweeping_distance(t(seed), t(speed), sweeps, t(sv))
    want = jl.fast_sweeping_distance(jnp.asarray(seed), jnp.asarray(speed),
                                     sweeps, jnp.asarray(sv))
    close(got, want, 1e-4)


def _twins_sweeps(u, f, num_sweeps):
    """The twin's fast sweeping op by op in torch: per round, its four
    directional sweeps in its order, each a loop over the rows with the
    neighbours built by ``torch.cat``."""
    big = torch.tensor([tl._BIG])
    f2 = 2.0 * f * f
    for _ in range(num_sweeps):
        for rr in (False, True):
            for rc in (False, True):
                dims = [d for d, r in ((0, rr), (1, rc)) if r]
                uu, ff, ff2 = ((a.flip(dims) if dims else a)
                               for a in (u, f, f2))
                prev = torch.full((u.shape[1],), tl._BIG)
                rows = []
                for row, fr, f2r in zip(uu, ff, ff2):
                    for _ in range(2):
                        ux = torch.minimum(torch.cat([big, row[:-1]]),
                                           torch.cat([row[1:], big]))
                        row = torch.minimum(
                            row, tl._eikonal_update(ux, prev, f2r, fr))
                    rows.append(row)
                    prev = row
                u = torch.stack(rows)
                u = u.flip(dims) if dims else u
    return u


@pytest.mark.parametrize("sweeps", [1, 3])
def test_paired_sweeps_equal_the_twins_four_directions(sweeps):
    """The port steps each pair of same-direction sweeps together; the
    result equals the twin's sequence of four directions, run op by op,
    bit for bit."""
    rs = np.random.RandomState(10 + sweeps)
    seed = rs.rand(40, 56) > 0.99
    f = t(rs.uniform(0.5, 2.0, (40, 56)).astype(np.float32))
    u0 = t(np.where(seed, rs.uniform(0, 0.5, seed.shape), tl._BIG)
           .astype(np.float32))
    got = tl.fast_sweeping_distance(t(seed), f, sweeps, u0)
    assert torch.equal(got, _twins_sweeps(u0, f, sweeps))


def test_signed_distance_signs():
    mask = np.zeros((32, 32), bool)
    mask[8:24, 8:24] = True
    sd = tl.signed_distance(t(mask))
    close(sd, jl.signed_distance(jnp.asarray(mask)), 1e-4)
    assert sd[16, 16] < 0
    assert sd[2, 2] > 0


def test_signed_distance_circle():
    n = 64
    y, x = np.mgrid[0:n, 0:n]
    mask = np.hypot(x - 32, y - 32) < 15
    sd = tl.signed_distance(t(mask))
    close(sd, jl.signed_distance(jnp.asarray(mask)), 1e-4)
    assert sd[32, 32] < -10
    assert sd[0, 0] > 20


def test_signed_distance_wraps_like_the_twin():
    """A region touching the image border: the twin's boundary test rolls
    (wraps) the mask, and so does the port's."""
    mask = np.zeros((40, 56), bool)
    mask[:, :10] = True
    mask[15:30, 30:] = True
    close(tl.signed_distance(t(mask)), jl.signed_distance(jnp.asarray(mask)),
          1e-4)


def test_reinitialize_recovers_signed_distance():
    phi0 = circle_np(96, 48, 48, 20)
    distorted = np.sign(phi0) * (np.abs(phi0) ** 1.5 + 0.2 * np.abs(phi0))
    distorted = distorted.astype(np.float32)
    phi = tl.reinitialize_signed_distance(t(distorted))
    close(phi, jl.reinitialize_signed_distance(jnp.asarray(distorted)), 1e-4)
    band = np.abs(phi0) < 10
    err = np.abs(phi.numpy() - phi0)[band]
    assert np.median(err) < 0.3
    assert np.max(err) < 1.0


# --- fluxes, derivatives, integrators ---------------------------------------

def _fields(seed, n=48, dims=2):
    rs = np.random.RandomState(seed)
    shape = (n,) * dims
    base = np.sqrt(sum((g - n / 2 + rs.uniform(-3, 3)) ** 2
                       for g in np.mgrid[tuple(slice(0, n) for _ in shape)]))
    phi = (base - n / 4 + 0.3 * rs.normal(size=shape)).astype(np.float32)
    vel = rs.normal(size=(dims,) + shape).astype(np.float32)
    beta = rs.normal(size=shape).astype(np.float32)
    return phi, vel, beta


@pytest.mark.parametrize("dims", [2, 3])
def test_fluxes_match_twin(dims):
    phi, vel, beta = _fields(dims, n=48 if dims == 2 else 20, dims=dims)
    jp, tp = jnp.asarray(phi), t(phi)
    cases = [
        (tl.advection(tp, t(vel)), jl.advection(jp, jnp.asarray(vel))),
        (tl.normal_motion(tp, 1.0), jl.normal_motion(jp, 1.0)),
        (tl.normal_motion(tp, -0.5), jl.normal_motion(jp, -0.5)),
        (tl.normal_motion(tp, t(beta)), jl.normal_motion(jp,
                                                         jnp.asarray(beta))),
        (tl.curvature_motion(tp), jl.curvature_motion(jp)),
        (tl.reinitialization_flux(tp, tp * 1.5),
         jl.reinitialization_flux(jp, jp * 1.5)),
        (tl.extension_flux(tp, t(beta)), jl.extension_flux(jp,
                                                           jnp.asarray(beta))),
        (tl.normal_field(tp), jl.normal_field(jp)),
        (tl._zero_crossing_mask(tp), jl._zero_crossing_mask(jp)),
    ]
    for a in range(dims):
        for got, want in zip(tl.weno3_derivatives(tp, a),
                             jl.weno3_derivatives(jp, a)):
            cases.append((got, want))
    for got, want in cases:
        assert got.shape == tuple(want.shape)
        close(got, want, 1e-5)


def test_weno3_exact_on_smooth_quadratic():
    x = np.arange(32, dtype=np.float32)
    u = np.tile((0.5 * x ** 2)[None, :], (4, 1))
    dm, dp = tl.weno3_derivatives(t(u), axis=1)
    jm, jp = jl.weno3_derivatives(jnp.asarray(u), axis=1)
    close(dm, jm, 1e-5)
    close(dp, jp, 1e-5)
    interior = np.s_[:, 3:-3]
    want = x[3:-3][None, :].repeat(4, 0)
    np.testing.assert_allclose(dm.numpy()[interior], want, atol=1e-3)
    np.testing.assert_allclose(dp.numpy()[interior], want, atol=1e-3)


def test_reinitialization_flux_fixed_point_is_distance():
    phi = circle_np(96, 48, 48, 18)
    flux = tl.reinitialization_flux(t(phi), t(phi))
    close(flux, jl.reinitialization_flux(jnp.asarray(phi), jnp.asarray(phi)),
          1e-5)
    band = np.abs(phi) < 12
    inner = band & (np.abs(phi) > 2)
    assert np.max(np.abs(flux.numpy()[inner])) < 0.15


def test_time_integrators_agree_on_linear_flux():
    phi = circle_np(64, 32, 32, 10)
    const = torch.full_like(t(phi), 0.7)
    flux = lambda u: const  # noqa: E731 - du/dt independent of u
    e = tl.euler_step(t(phi), flux(t(phi)), 0.2)
    m = tl.midpoint_step(t(phi), flux, 0.2)
    r = tl.tvd_rk2_step(t(phi), flux, 0.2)
    np.testing.assert_allclose(e.numpy(), m.numpy(), atol=1e-6)
    np.testing.assert_allclose(e.numpy(), r.numpy(), atol=1e-6)


@pytest.mark.parametrize("integrator", ["euler_step", "midpoint_step",
                                        "tvd_rk2_step"])
def test_integrators_match_twin(integrator):
    phi, _, _ = _fields(7)
    dom = np.abs(phi) <= 5.0
    port, twin = getattr(tl, integrator), getattr(jl, integrator)
    for d in (None, dom):
        dj = None if d is None else jnp.asarray(d)
        dt_ = None if d is None else t(d)
        if integrator == "euler_step":
            got = port(t(phi), tl.curvature_motion(t(phi)), 0.3, dt_)
            want = twin(jnp.asarray(phi), jl.curvature_motion(
                jnp.asarray(phi)), 0.3, dj)
        else:
            got = port(t(phi), tl.curvature_motion, 0.3, dt_)
            want = twin(jnp.asarray(phi), jl.curvature_motion, 0.3, dj)
        close(got, want, 1e-5)


def test_domain_mask_gates_updates():
    phi = circle_np(64, 32, 32, 10)
    dom = np.abs(phi) <= 5.0
    out = tl.euler_step(t(phi), torch.ones(64, 64), 1.0, domain=t(dom))
    delta = out.numpy() - phi
    assert np.allclose(delta[dom], 1.0, atol=1e-5)
    assert np.all(delta[~dom] == 0.0)


# --- evolutions ---------------------------------------------------------------

def _evolve(mod, phi, flux, dt, steps):
    for _ in range(steps):
        phi = mod.tvd_rk2_step(phi, flux, dt)
    return phi


def test_normal_motion_expands_circle_at_unit_speed():
    n, r0, dt, steps = 96, 15.0, 0.4, 25
    phi = circle_np(n, 48, 48, r0)
    pt = _evolve(tl, t(phi), lambda u: tl.normal_motion(u, 1.0), dt, steps)
    pj = _evolve(jl, jnp.asarray(phi), lambda u: jl.normal_motion(u, 1.0),
                 dt, steps)
    close(pt, pj, 1e-4)
    r = front_radius(pt, 48, 48, tl)
    assert abs(r - (r0 + dt * steps)) < 0.35


def test_curvature_flow_shrinking_circle_radius_law():
    """dR/dt = -1/R  =>  R(t) = sqrt(R0^2 - 2 t), 1000 steps with a
    reinitialisation every 50."""
    n, r0, dt, steps = 128, 22.0, 0.1, 1000
    pt, pj = t(circle_np(n, 64, 64, r0)), jnp.asarray(circle_np(n, 64, 64,
                                                               r0))
    for _ in range(steps // 50):
        pt = tl.reinitialize_signed_distance(
            _evolve(tl, pt, tl.curvature_motion, dt, 50))
        pj = jl.reinitialize_signed_distance(
            _evolve(jl, pj, jl.curvature_motion, dt, 50))
    r_true = float(np.sqrt(r0 ** 2 - 2 * dt * steps))
    r = front_radius(pt, 64, 64, tl)
    assert abs(r - r_true) < 0.3, (r, r_true)
    assert abs(r - front_radius(pj, 64, 64, jl)) < 1e-3


def test_advection_translates_front():
    n, dt, steps = 96, 0.5, 20
    phi = circle_np(n, 40, 48, 12)
    v = np.stack([np.zeros((n, n)), np.ones((n, n))]).astype(np.float32)
    pt = _evolve(tl, t(phi), lambda u: tl.advection(u, t(v)), dt, steps)
    pj = _evolve(jl, jnp.asarray(phi),
                 lambda u: jl.advection(u, jnp.asarray(v)), dt, steps)
    close(pt, pj, 1e-4)
    assert abs(front_radius(pt, 50, 48, tl) - 12.0) < 0.5


def _sphere(n, c, r):
    z, y, x = np.mgrid[0:n, 0:n, 0:n]
    return (np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
            - r).astype(np.float32)


def _radius3d(phi, c):
    m = tl._zero_crossing_mask(phi).numpy()
    zz, yy, xx = np.nonzero(m)
    return float((np.sqrt((xx - c[0]) ** 2 + (yy - c[1]) ** 2
                          + (zz - c[2]) ** 2) - phi.numpy()[zz, yy, xx]).mean())


def test_fluxes_work_in_3d():
    n, r0, dt, steps = 48, 10.0, 0.4, 12
    phi = _sphere(n, (24, 24, 24), r0)
    pt = _evolve(tl, t(phi), lambda u: tl.normal_motion(u, 1.0), dt, steps)
    pj = _evolve(jl, jnp.asarray(phi), lambda u: jl.normal_motion(u, 1.0),
                 dt, steps)
    close(pt, pj, 1e-4)
    assert abs(_radius3d(pt, (24, 24, 24)) - (r0 + dt * steps)) < 0.5


def test_advection_3d_translates():
    n, dt, steps = 40, 0.5, 12
    phi = _sphere(n, (14, 20, 20), 8.0)
    v = np.stack([np.zeros((n, n, n)), np.zeros((n, n, n)),
                  np.ones((n, n, n))]).astype(np.float32)
    pt = _evolve(tl, t(phi), lambda u: tl.advection(u, t(v)), dt, steps)
    pj = _evolve(jl, jnp.asarray(phi),
                 lambda u: jl.advection(u, jnp.asarray(v)), dt, steps)
    close(pt, pj, 1e-4)
    assert abs(_radius3d(pt, (20, 20, 20)) - 8.0) < 0.5


# --- the narrow band ----------------------------------------------------------

@pytest.fixture
def twin_reinits(monkeypatch):
    """Counts the twin's reinitialisations (its constructor's included)."""
    calls = []
    orig = jl.reinitialize_signed_distance

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(jl, "reinitialize_signed_distance", counted)
    return calls


@pytest.mark.parametrize("band,speed", [(6.0, 1.0), (5.0, 1.0),
                                        (4.0, -1.0)])
def test_narrow_band_20_steps_match_twin(band, speed, twin_reinits):
    """20 band-gated steps: phi within 1e-4 of the twin's, the same number
    of reinitialisations, one device read per step."""
    n, r0 = 96, 14.0 if speed > 0 else 24.0
    phi0 = circle_np(n, 48, 48, r0)
    nbt = tl.NarrowBand(phi0, band_radius=band, device="cpu")
    assert nbt.phi.device == torch.device("cpu")
    nbt.run(lambda u: tl.normal_motion(u, speed), 0.4, 20)
    nbj = jl.NarrowBand(jnp.asarray(phi0), band_radius=band)
    nbj.run(lambda u: jl.normal_motion(u, speed), 0.4, 20)
    close(nbt.phi, nbj.phi, 1e-4)
    assert nbt.reinits == len(twin_reinits) - 1
    assert nbt.syncs == 20
    if band == 5.0:
        assert nbt.reinits >= 1


def test_narrow_band_matches_full_grid_near_front():
    n, r0, dt, steps = 96, 14.0, 0.4, 20
    phi0 = circle_np(n, 48, 48, r0)
    flux = lambda u: tl.normal_motion(u, 1.0)  # noqa: E731
    full = _evolve(tl, t(phi0), flux, dt, steps)
    nb = tl.NarrowBand(t(phi0), band_radius=6.0)
    nb.run(flux, dt, steps)
    r_full = front_radius(full, 48, 48, tl)
    r_band = front_radius(nb.phi, 48, 48, tl)
    assert abs(r_full - r_band) < 0.3
    assert abs(r_band - (r0 + dt * steps)) < 0.6


def test_narrow_band_reinit_triggers(twin_reinits):
    """75 steps with several reinitialisations: the radius law, the twin's
    count of reinitialisations, the front within 1e-3 px of the twin's."""
    n, r0, dt, steps = 128, 10.0, 0.4, 75
    phi0 = circle_np(n, 64, 64, r0)
    nb = tl.NarrowBand(t(phi0), band_radius=5.0)
    nb.run(lambda u: tl.normal_motion(u, 1.0), dt, steps)
    nbj = jl.NarrowBand(jnp.asarray(phi0), band_radius=5.0)
    nbj.run(lambda u: jl.normal_motion(u, 1.0), dt, steps)
    r = front_radius(nb.phi, 64, 64, tl)
    assert abs(r - (r0 + dt * steps)) < 1.0
    assert nb.reinits == len(twin_reinits) - 1 >= 3
    assert abs(r - front_radius(nbj.phi, 64, 64, jl)) < 1e-3


def test_narrow_band_forced_cadence(twin_reinits):
    phi0 = circle_np(64, 32, 32, 12)
    nb = tl.NarrowBand(t(phi0), band_radius=6.0)
    nb.run(tl.curvature_motion, 0.2, 12, integrator=tl.midpoint_step,
           reinit_every=4)
    nbj = jl.NarrowBand(jnp.asarray(phi0), band_radius=6.0)
    nbj.run(jl.curvature_motion, 0.2, 12, integrator=jl.midpoint_step,
            reinit_every=4)
    close(nb.phi, nbj.phi, 1e-4)
    assert nb.reinits == len(twin_reinits) - 1 >= 3


def test_narrow_band_defaults_to_the_card():
    """A host phi goes to the card by default (raises without one)."""
    phi0 = circle_np(32, 16, 16, 6)
    if torch.cuda.is_available():
        assert tl.NarrowBand(phi0).phi.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.NarrowBand(phi0)
