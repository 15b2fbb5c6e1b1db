"""Level sets: signed distance by fast sweeping (eikonal solver), upwind
fluxes, TVD time integrators and the narrow-band driver.

Twin of ``sara_tpu/image/levelsets.py`` (reference:
cpp/src/DO/Sara/ImageProcessing/LevelSets/FastMarching.hpp,
FiniteDifferences.hpp, Flux.hpp:20-127, TimeIntegrators.hpp:21-93,
NarrowBand.hpp:20-270).

- Fast sweeping is the twin's Godunov Gauss-Seidel solver: each sweep runs
  over the rows, one step per row, each step a vector operation over the
  whole row. The twin's column-reversed sweeps equal its forward ones (a
  row's update is symmetric in its left and right neighbours), so a round
  of its four directions is two top-down and two bottom-up sweeps, and the
  port steps each such pair together, the second one row behind the first
  (``_two_sweeps``); the result is the sequential one bit for bit. The grid
  is padded once with border columns of the twin's ``_BIG`` (1e10, not
  inf), so a row's neighbours are views, never a ``torch.cat`` per step. A
  call at (H, W) is ``num_sweeps x 2 x (H + 1)`` steps of 31 launches and
  reads nothing back: at 480x640 and 4 sweeps, 3,848 steps and ~119,000
  launches, bound by the host's launch rate. Square roots are correctly
  rounded on either device (``_sqrt``).
- The flux operators are dimension-generic (2-D and 3-D), as in the twin.
- ``NarrowBand.reinit_needed`` reads one boolean from the device per step
  (``bool(torch.any(...))``), as the twin does: the driver's control flow
  depends on it. ``NarrowBand.syncs`` counts those reads and
  ``NarrowBand.reinits`` the reinitialisations.

Each function runs where its input tensor lies; a host array goes to the
card, or to ``device`` where a function takes one.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.utils.host import as_tensor

_BIG = 1e10


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as CUDA's and XLA's are. The CPU's
    vectorized float32 ``torch.sqrt`` is off by one ulp for ~17% of
    inputs, which moved the card's 480x640 fast sweeping 11 ulps from the
    CPU's; so a float32 square root on the CPU is taken in float64 and
    rounded once (correctly rounded for float32 inputs)."""
    if x.is_cuda or x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _eikonal_update(u_x, u_y, f2, f):
    """Godunov eikonal update from axis-neighbor minima (unit grid);
    ``f2`` is ``2 f f``, computed once per call."""
    a = torch.minimum(u_x, u_y)
    b = torch.maximum(u_x, u_y)
    # 1-D update if the difference is large, else 2-D quadratic solution.
    one_d = a + f
    d = u_x - u_y
    disc = f2 - d * d
    two_d = 0.5 * (u_x + u_y + _sqrt(torch.clamp_min(disc, 0.0)))
    return torch.where(one_d <= b, one_d, two_d)


def _speed_rows(f: torch.Tensor) -> torch.Tensor:
    """``f`` (H, W) laid out for :func:`_two_sweeps`' buffer: (2, H + 2, W),
    rows 1..H of layer 0 and rows 2..H+1 of layer 1, zeros elsewhere."""
    H, W = f.shape
    out = f.new_zeros((2, H + 2, W))
    out[0, 1:H + 1] = f
    out[1, 2:] = f
    return out


def _two_sweeps(u, f, f2):
    """Two successive top-down sweeps of ``u`` (H, W), the second one row
    behind the first, each step a vector operation over the two rows.

    The twin's sweep updates a row from the previous row and its own left
    and right neighbours, symmetric in the two: its column-reversed sweep
    equals the forward one bit for bit. So a round of the twin's four
    directions is two top-down sweeps, then two bottom-up ones. In the
    buffer ``p`` (2, H + 2, W + 2), layer 0 holds the first sweep (row 0
    its initial previous row of _BIG, rows 1..H the data, row H + 1 a
    scratch row) and layer 1 the second (rows 2..H+1 the data, row 1 its
    initial previous row). Step k updates ``p[:, k]``: the first sweep's
    data row k and the second's data row k - 1, whose input is the first
    sweep's row k - 1, finished one step before. The second sweep's initial
    row is _BIG with a speed of 0, which the update leaves _BIG. Columns 0
    and W + 1 are the _BIG borders of the left and right neighbours, so a
    row's neighbours are views of the buffer, never a ``torch.cat``.
    ``f``, ``f2``: the speed and ``2 f f`` from :func:`_speed_rows`."""
    H, W = u.shape
    p = torch.full((2, H + 2, W + 2), _BIG, dtype=u.dtype, device=u.device)
    p[0, 1:H + 1, 1:-1] = u
    for k in range(1, H + 2):
        p[1, k, 1:-1].copy_(p[0, k - 1, 1:-1])
        prev, row = p[:, k - 1, 1:-1], p[:, k, 1:-1]
        for _ in range(2):       # the update and one Gauss-Seidel refinement
            ux = torch.minimum(p[:, k, :-2], p[:, k, 2:])
            torch.minimum(row, _eikonal_update(ux, prev, f2[:, k], f[:, k]),
                          out=row)
    return p[1, 2:, 1:-1]


def fast_sweeping_distance(seed_mask, speed=None, num_sweeps: int = 4,
                           seed_values=None):
    """Distance transform from seed pixels by fast sweeping.

    seed_mask: (H, W) bool — the zero level set. speed: optional (H, W)
    slowness f (default 1 -> euclidean-like distance). seed_values:
    optional (H, W) initial distances at seed pixels (default 0 — pass the
    sub-cell distance |phi|/|grad phi| for a first-order-accurate
    interface). Returns (H, W) u.
    """
    seed_mask = as_tensor(seed_mask, bool)
    dev = seed_mask.device
    H, W = seed_mask.shape
    f = (torch.ones((H, W), dtype=torch.float32, device=dev) if speed is None
         else as_tensor(speed, device=dev))
    sv = (torch.zeros((H, W), dtype=torch.float32, device=dev)
          if seed_values is None else as_tensor(seed_values, device=dev))
    u = sv.masked_fill(~seed_mask, _BIG)
    f2 = 2.0 * f * f
    down = _speed_rows(f), _speed_rows(f2)
    up = _speed_rows(f.flip(0)), _speed_rows(f2.flip(0))
    for _ in range(num_sweeps):
        u = _two_sweeps(u, *down)
        u = _two_sweeps(u.flip(0), *up).flip(0)
    return u.contiguous()


def signed_distance(mask, num_sweeps: int = 4):
    """Signed distance to the boundary of a binary region (positive
    outside). The boundary test wraps around the image (``torch.roll``), as
    the twin's ``jnp.roll`` does."""
    m = as_tensor(mask, bool)
    boundary = m & ~(
        torch.roll(m, 1, 0) & torch.roll(m, -1, 0)
        & torch.roll(m, 1, 1) & torch.roll(m, -1, 1))
    d = fast_sweeping_distance(boundary, num_sweeps=num_sweeps)
    return torch.where(m, -d, d)


# --------------------------------------------------------------------------
# Level-set evolution machinery: upwind finite differences, flux operators,
# TVD time integrators, narrow-band driver. As in the twin, the whole grid
# is one vectorized program: the "narrow band" is a mask that gates
# updates, and reinitialization is the fast-sweeping eikonal solver above.
# --------------------------------------------------------------------------


def _fwd(u, axis):
    """Forward difference u[i+1]-u[i]; zero at the high border (the
    reference clamps out-of-range coordinates, FiniteDifferences.hpp)."""
    n = u.shape[axis]
    out = torch.zeros_like(u)
    out.narrow(axis, 0, n - 1).copy_(torch.diff(u, dim=axis))
    return out


def _bwd(u, axis):
    """Backward difference u[i]-u[i-1]; zero at the low border."""
    n = u.shape[axis]
    out = torch.zeros_like(u)
    out.narrow(axis, 1, n - 1).copy_(torch.diff(u, dim=axis))
    return out


def _take_shifted(u, axis, k):
    """output[i] = u[clip(i + k)] along ``axis`` (border-clamped)."""
    n = u.shape[axis]
    idx = (torch.arange(n, device=u.device) + k).clamp(0, n - 1)
    return u.index_select(axis, idx)


def _central(u, axis):
    return 0.5 * (_take_shifted(u, axis, 1) - _take_shifted(u, axis, -1))


def _weno3(dm2, dm1, d0):
    """WENO3 reconstruction of a one-sided derivative from three
    consecutive first differences (reference: FiniteDifferences.hpp WENO3)."""
    eps = 1e-6
    b0 = (d0 - dm1) ** 2
    b1 = (dm1 - dm2) ** 2
    a0 = (2.0 / 3.0) / (b0 + eps) ** 2
    a1 = (1.0 / 3.0) / (b1 + eps) ** 2
    w = a0 / (a0 + a1)
    return w * 0.5 * (dm1 + d0) + (1.0 - w) * (1.5 * dm1 - 0.5 * dm2)


def weno3_derivatives(u, axis):
    """(backward, forward) WENO3 one-sided derivatives along ``axis``."""
    d = _bwd(u, axis)  # d[i] = u[i]-u[i-1]

    def shift(k):  # output[i] = d[i+k], border-clamped like the reference
        return _take_shifted(d, axis, k)

    dm = _weno3(shift(-1), d, shift(1))
    dp = _weno3(shift(2), shift(1), d)
    return dm, dp


def normal_field(u, eps: float = 1e-6):
    """Unit normal grad(u)/|grad(u)| via central differences
    (reference: Flux.hpp::normal)."""
    g = torch.stack([_central(u, a) for a in range(u.dim())])
    n = _sqrt(torch.sum(g * g, 0))
    return g / torch.clamp_min(n, eps)


def advection(u, velocity):
    """Upwind advection term -<v, grad u> (reference: Flux.hpp::advection).

    velocity: (ndim, H, W) field. Returns du/dt contribution."""
    delta = torch.zeros_like(u)
    for a in range(u.dim()):
        v = velocity[a]
        du = torch.where(v > 0, _bwd(u, a), _fwd(u, a))
        delta = delta - v * du
    return delta


def _upwind_squares(u):
    """The Godunov sums of squared one-sided differences for a positive
    and a negative speed."""
    sq_pos = torch.zeros_like(u)
    sq_neg = torch.zeros_like(u)
    for a in range(u.dim()):
        up = _fwd(u, a)
        um = _bwd(u, a)
        sq_pos = sq_pos + (torch.clamp_max(up, 0.0) ** 2
                           + torch.clamp_min(um, 0.0) ** 2)
        sq_neg = sq_neg + (torch.clamp_min(up, 0.0) ** 2
                           + torch.clamp_max(um, 0.0) ** 2)
    return sq_pos, sq_neg


def normal_motion(u, beta):
    """Godunov upwind normal motion -beta * |grad u|
    (reference: Flux.hpp::normal_motion). beta: scalar or (H, W) field."""
    beta = torch.as_tensor(beta, dtype=u.dtype, device=u.device)
    sq_pos, sq_neg = _upwind_squares(u)
    grad = torch.where(beta > 0, _sqrt(sq_pos), _sqrt(sq_neg))
    return -beta * grad


def curvature_motion(u, eps: float = 1e-6):
    """Mean-curvature motion kappa * |grad u| with
    kappa = div(grad u / |grad u|): a circle of radius R shrinks at
    dR/dt = -1/R."""
    g = torch.stack([_central(u, a) for a in range(u.dim())])
    norm = _sqrt(torch.sum(g * g, 0))
    n = g / torch.clamp_min(norm, eps)
    kappa = torch.zeros_like(u)
    for a in range(u.dim()):
        kappa = kappa + _central(n[a], a)
    return kappa * norm


def reinitialization_flux(u, u0, delta: float = 1.0):
    """PDE reinitialization flux S(u0) (1 - |grad u|) with Godunov
    upwinding by the smoothed sign of u0
    (reference: Flux.hpp::reinitialization)."""
    s = u0 / _sqrt(u0 * u0 + delta * delta)
    sq_pos, sq_neg = _upwind_squares(u)
    grad = torch.where(s > 0, _sqrt(sq_neg), _sqrt(sq_pos))
    return s * (1.0 - grad)


def extension_flux(u, d, delta: float = 1.0):
    """Velocity-extension flux: advect quantity ``d`` along the outward
    normal of ``u`` scaled by the smoothed sign of u
    (reference: Flux.hpp::extension)."""
    v = normal_field(u)
    s = u / _sqrt(u * u + delta * delta)
    return advection(d, v * s)


def euler_step(u, du, dt, domain=None):
    """Forward-Euler update, optionally gated to a domain mask
    (reference: TimeIntegrators.hpp::EulerIntegrator)."""
    new = u + dt * du
    return torch.where(domain, new, u) if domain is not None else new


def midpoint_step(u, flux_fn, dt, domain=None):
    """Midpoint (RK2) update: full step evaluated at the half-step state
    (reference: TimeIntegrators.hpp::MidpointIntegrator)."""
    half = euler_step(u, flux_fn(u), 0.5 * dt, domain)
    return euler_step(u, flux_fn(half), dt, domain)


def tvd_rk2_step(u, flux_fn, dt, domain=None):
    """TVD (SSP) RK2: average of two Euler stages — total-variation
    stability for the upwind fluxes above."""
    u1 = euler_step(u, flux_fn(u), dt, domain)
    u2 = euler_step(u1, flux_fn(u1), dt, domain)
    out = 0.5 * (u + u2)
    return torch.where(domain, out, u) if domain is not None else out


def _zero_crossing_mask(phi):
    """Cells adjacent to a sign change along any axis
    (reference: NarrowBand.hpp::populate_zero_crossings)."""
    m = torch.zeros(phi.shape, dtype=torch.bool, device=phi.device)
    for a in range(phi.dim()):
        nxt = _take_shifted(phi, a, 1)
        prv = _take_shifted(phi, a, -1)
        m = m | (phi * nxt <= 0) | (phi * prv <= 0)
    return m


def reinitialize_signed_distance(phi, num_sweeps: int = 4):
    """Rebuild phi as a signed distance to its own zero level set, seeding
    interface cells with the first-order sub-cell distance
    |phi| / |grad phi| (the reference's two FastMarching reinitializers,
    NarrowBand.hpp:33-35)."""
    phi = as_tensor(phi)
    seeds = _zero_crossing_mask(phi)
    g = torch.stack([_central(phi, a) for a in range(phi.dim())])
    gn = torch.clamp_min(_sqrt(torch.sum(g * g, 0)), 1e-6)
    sub = torch.abs(phi) / gn
    d = fast_sweeping_distance(seeds, num_sweeps=num_sweeps,
                               seed_values=sub)
    return torch.where(phi < 0, -d, d)


class NarrowBand:
    """Narrow-band level-set evolution driver
    (reference: NarrowBand.hpp:20-270, LevelSets/FastMarching.hpp).

    Maintains phi as an approximate signed distance, evolves it only inside
    the band |phi| <= band_radius, and reinitializes (fast sweeping) when
    the front approaches the band edge — detected exactly like the
    reference's ``reinit_needed``: a cell whose |phi| exceeded ``thres`` at
    the last reinit has flipped sign. A host ``phi`` goes to ``device``
    (None: the card); a tensor stays on its device unless ``device`` is
    given.
    """

    def __init__(self, phi, band_radius: float = 6.0, device=None):
        self.band_radius = float(band_radius)
        self.syncs = 0
        self.reinits = 0
        self.phi = reinitialize_signed_distance(
            as_tensor(phi, device=device))
        self._snapshot()

    def _snapshot(self):
        self.phi_prev = self.phi
        self.band = torch.abs(self.phi) <= self.band_radius

    def _reinitialize(self):
        self.phi = reinitialize_signed_distance(self.phi)
        self.reinits += 1
        self._snapshot()

    def reinit_needed(self, thres: float | None = None) -> bool:
        thres = self.band_radius / 2.0 if thres is None else thres
        prev, curr = self.phi_prev, self.phi
        flip = ((prev > thres) & (curr <= 0)) | ((prev < -thres) & (curr >= 0))
        self.syncs += 1
        return bool(torch.any(flip & self.band))

    def step(self, flux_fn, dt: float, integrator=tvd_rk2_step):
        """One band-gated time step; reinitializes when needed."""
        self.phi = integrator(self.phi, flux_fn, dt, domain=self.band)
        if self.reinit_needed():
            self._reinitialize()

    def run(self, flux_fn, dt: float, steps: int,
            integrator=tvd_rk2_step, reinit_every: int = 0):
        """Evolve ``steps`` iterations; optional forced reinit cadence."""
        for i in range(steps):
            self.step(flux_fn, dt, integrator)
            if reinit_every and (i + 1) % reinit_every == 0:
                self._reinitialize()
        return self.phi
