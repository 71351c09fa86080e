"""The correlated field of a configuration, written from its equations.

``s(p) = offset + H(A(θ) ⊙ ξ)`` on an n × n grid of spacing 1/n (total
volume 1): ``H`` the Hartley transform ``Re F − Im F`` (``torch.fft``),
``ξ`` the excitation, ``A`` the harmonic amplitude of the hyper-parameters
``θ``:

- the zero mode ``A₀ = a_zm`` (log-normal ``zeromode``);
- elsewhere ``A(k) = flu · spec(k) / sqrt(Σ_{k'≠0} spec(k')²)``, ``flu``
  log-normal, ``spec = exp(slope · x(k) + dev(x(k)))`` with ``x = log(|k| /
  k_min)``, ``slope`` normal, and ``dev`` an integrated Wiener process in
  ``x`` (its ``flexibility`` log-normal) with its end-to-end slope removed:
  - exact form: one value per unique |k|, the process stepping from one
    unique |k| to the next (from the smallest non-zero one);
  - knot form: the process on K knots ``linspace(0, x_max, K)``, ``dev``
    its linear interpolation per pixel, written as the sum of relu
    features ``Σ_k c_k relu(x − t_k)`` (``c`` the slope changes at the
    knots) in blocks of pixels: its pull-back is then a matrix product,
    where a gather's would be 10⁸ atomic adds into 64 bins; and it is the
    form in which the TF32 control rounds the products' operands."""

from __future__ import annotations

import math

import torch

from .precision import Precision

__all__ = ["Field", "hartley", "lognormal_moments"]

KEYS = ("fluctuations", "flexibility", "loglogavgslope", "spectrum", "xi", "zeromode")


def lognormal_moments(mean, std):
    """``(log mean, log std)`` of the log-normal with this mean and std."""
    logstd = math.sqrt(math.log1p((std / mean) ** 2))
    return math.log(mean) - 0.5 * logstd**2, logstd


def hartley(x):
    """``Re F(x) − Im F(x)`` over the last two axes."""
    f = torch.fft.fft2(x.to(torch.complex128 if x.dtype == torch.float64 else torch.complex64))
    return f.real - f.imag


def iwp(xi, sigma, dt):
    """The integrated coordinate of an integrated Wiener process started at
    0 with the steps ``dt`` (N,), driven by ``xi`` (N, 2); (N + 1,)."""
    amp = sigma * torch.sqrt(dt)
    incr_s = amp * xi[:, 1]
    incr_y = amp * xi[:, 0] * torch.sqrt(dt**2 / 12.0) + 0.5 * dt * incr_s
    zero = incr_s.new_zeros(1)
    s = torch.cumsum(torch.cat((zero, incr_s)), 0)
    return torch.cumsum(torch.cat((zero, incr_y + dt * s[:-1])), 0)


class _ReluFeatures(torch.autograd.Function):
    """``Σ_k coef_k relu(x − t_k)`` per pixel of ``x`` (flat), in pixel
    blocks, its operands rounded by ``prec.matmul_operand``; linear in
    ``coef``, so its jvp is itself and its pull-back the transposed sum."""

    @staticmethod
    def forward(x, t, coef, prec):
        return _ReluFeatures.apply_plain(x, t, coef, prec)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.x, ctx.t, _, ctx.prec = inputs

    @staticmethod
    def apply_plain(x, t, coef, prec):
        out = torch.empty_like(x)
        c = prec.matmul_operand(coef)
        for lo in range(0, x.numel(), 1 << 22):
            f = prec.matmul_operand(torch.clamp_min(x[lo: lo + (1 << 22), None] - t, 0.0))
            out[lo: lo + (1 << 22)] = f @ c
        return out

    @staticmethod
    def backward(ctx, g):
        grad = torch.zeros_like(ctx.t)
        for lo in range(0, ctx.x.numel(), 1 << 22):
            f = ctx.prec.matmul_operand(torch.clamp_min(ctx.x[lo: lo + (1 << 22), None] - ctx.t, 0.0))
            grad += ctx.prec.matmul_operand(g[lo: lo + (1 << 22)]) @ f
        return None, None, grad, None

    @staticmethod
    def jvp(ctx, x_t, t_t, coef_t, _):
        return _ReluFeatures.apply_plain(ctx.x, ctx.t, coef_t, ctx.prec)


class Field:
    """The reference field of ``model`` (a configuration's ``model`` entry)
    on ``device`` in the precision ``prec``.  A position is a dict of the
    keys :data:`KEYS` prefixed by ``model["prefix"]``."""

    def __init__(self, model: dict, device, prec: Precision = None):
        self.prec = prec or Precision()
        dt = self.prec.dtype
        self.device = torch.device(device)
        n = int(model["grid_side"])
        self.n, self.ndim = n, 2
        self.shape = (n, n)
        self.prefix = model["prefix"]
        self.offset = float(model["offset_mean"])
        self.zm = lognormal_moments(*model["offset_std"])
        self.flu = lognormal_moments(*model["fluctuations"])
        self.flx = lognormal_moments(*model["flexibility"])
        self.slope = tuple(model["loglogavgslope"])
        self.knots_n = model.get("n_mode_knots")
        # |k|² in units of (1/(n d))² = 1: integers i² + j² with the folded indices
        fold = torch.arange(n, device=device, dtype=torch.int64)
        fold = torch.minimum(fold, n - fold)
        m = fold[:, None] ** 2 + fold[None, :] ** 2
        self.nonzero = m > 0
        xgrid = torch.where(self.nonzero, 0.5 * torch.log(m.clamp_min(1).double()), 0.0)
        if self.knots_n is None:
            uniq, inv = torch.unique(m.reshape(-1), return_inverse=True)
            self.mode_index = inv.reshape(self.shape)
            self.n_modes = uniq.numel()
            rel = torch.log(uniq[1:].double()) * 0.5
            rel = torch.cat((rel.new_zeros(1), rel - rel[0]))  # 0 at |k| = 0 and at k_min
            self.rel = rel.to(dt)
            self.log_vol = (rel[2:] - rel[1:-1]).to(dt)
            self.n_steps = self.n_modes - 2
        else:
            kmax = 0.5 * math.log(2 * (n // 2) ** 2)
            knots = torch.linspace(0.0, kmax, int(self.knots_n), dtype=torch.float64, device=device)
            self.knots = knots.to(dt)
            self.log_vol = torch.diff(knots).to(dt)
            self.x = xgrid.to(dt).reshape(-1)
            self.n_steps = int(self.knots_n) - 1

    # -- the domain -----------------------------------------------------------

    def key(self, name):
        return self.prefix + name

    def domain(self):
        """``{key: shape}`` of a position."""
        shapes = {"fluctuations": (), "flexibility": (), "loglogavgslope": (),
                  "spectrum": (self.n_steps, 2), "xi": self.shape, "zeromode": ()}
        return {self.key(k): shapes[k] for k in KEYS}

    # -- the amplitude ----------------------------------------------------------

    def _deviations(self, p):
        flex = torch.exp(self.flx[0] + self.flx[1] * p[self.key("flexibility")])
        y = iwp(p[self.key("spectrum")], flex, self.log_vol)
        if self.knots_n is None:
            y = torch.cat((y.new_zeros(1), y))
            return y - y[-1] * (self.rel / self.rel[-1])
        return y - y[-1] * (self.knots / self.knots[-1])

    def _ln_spectrum(self, p):
        """The log spectrum on the full grid (any value at the zero mode)."""
        slope = self.slope[0] + self.slope[1] * p[self.key("loglogavgslope")]
        d = self._deviations(p)
        if self.knots_n is None:
            return (slope * self.rel + d)[self.mode_index]
        seg = torch.diff(d) / torch.diff(self.knots)
        coef = torch.cat((seg[:1], torch.diff(seg)))
        dev = _ReluFeatures.apply(self.x, self.knots[:-1], coef, self.prec)
        return (slope * self.x + dev).reshape(self.shape)

    def amplitude(self, p):
        """``A(θ)`` on the full grid."""
        spec = torch.where(self.nonzero, torch.exp(self._ln_spectrum(p)), 0.0)
        norm = torch.sqrt(torch.sum(spec * spec))
        flu = torch.exp(self.flu[0] + self.flu[1] * p[self.key("fluctuations")])
        azm = torch.exp(self.zm[0] + self.zm[1] * p[self.key("zeromode")])
        return self.prec.store(torch.where(self.nonzero, (flu / norm) * spec, azm))

    def hyper(self, p):
        """The position's hyper-parameters: every key but ξ."""
        return {k: v for k, v in p.items() if k != self.key("xi")}

    # -- the field and its derivatives -------------------------------------------

    def transform(self, x):
        return self.prec.store(hartley(self.prec.store(x)))

    def forward(self, p):
        a = self.amplitude(self.hyper(p))
        return self.offset + self.transform(a * p[self.key("xi")])

    def linearization(self, p):
        """``(s, jvp, vjp)`` at ``p``: the field, its push-forward of a
        tangent and its pull-back of a field-shaped cotangent."""
        hyper = self.hyper(p)
        xi = p[self.key("xi")]
        a, vjp_a = torch.func.vjp(self.amplitude, hyper)
        s = self.offset + self.transform(a * xi)

        def jvp(t):
            _, da = torch.func.jvp(self.amplitude, (hyper,), (self.hyper(t),))
            return self.transform(da * xi + a * t[self.key("xi")])

        def vjp(w):
            u = self.transform(w)
            (g,) = vjp_a(self.prec.store(xi * u))
            g = dict(g)
            g[self.key("xi")] = self.prec.store(a * u)
            return {k: g[k] for k in p}

        return s, jvp, vjp
