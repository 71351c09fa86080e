"""Plotting: multi-panel figures of fields, spectra and samples
(counterpart of ``nifty_tpu/plot.py``).

Host code on numpy: queue panels (1-D lines, 2-D images, RING-ordered
HEALPix maps in the Mollweide projection, histograms, log-log spectra,
spectral cubes as sRGB) and lay them out in one figure.  Tensors are
copied to the host; matplotlib is imported only when a figure is drawn.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .ops.sht import healpix_ring_geometry

__all__ = ["Plot", "mollweide_grid_from_healpix", "rgb_from_spectral_cube"]


def _np(x):
    """``x`` as a numpy array (a tensor copied from its device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ring_pixel_angles(nside):
    z, nphi, phi0, _ = healpix_ring_geometry(nside)
    theta = np.arccos(z)
    th, ph = [], []
    for t, n, p0 in zip(theta, nphi, phi0):
        th.append(np.full(n, t))
        ph.append(p0 + 2 * np.pi * np.arange(n) / n)
    return np.concatenate(th), np.concatenate(ph)


def mollweide_grid_from_healpix(m, xsize=800):
    """Sample a RING-ordered HEALPix map onto a 2-D Mollweide grid of
    ``(xsize//2, xsize)`` (nearest-pixel lookup; NaN outside the disk)."""
    m = _np(m)
    npix = m.size
    nside = int(np.sqrt(npix / 12))
    if 12 * nside**2 != npix:
        raise ValueError(f"{npix} is not a valid HEALPix pixel count")
    ysize = xsize // 2
    xx, yy = np.meshgrid(
        np.linspace(-2.0, 2.0, xsize), np.linspace(-1.0, 1.0, ysize)
    )
    disk = (xx / 2.0) ** 2 + yy**2 <= 1.0
    out = np.full((ysize, xsize), np.nan)

    # inverse Mollweide
    sin_t = yy[disk]
    aux = np.sqrt(1.0 - sin_t**2)
    lat = np.arcsin(
        np.clip((2.0 * np.arcsin(sin_t) + 2.0 * sin_t * aux) / np.pi, -1, 1)
    )
    lon = np.pi * xx[disk] / (2.0 * np.maximum(aux, 1e-12) * 2.0) * 2.0
    theta_q = np.pi / 2.0 - lat
    phi_q = np.mod(lon, 2 * np.pi)

    # nearest-pixel via ring search (vectorized)
    z_r, nphi, phi0, start = healpix_ring_geometry(nside)
    theta_r = np.arccos(z_r)
    ring = np.clip(np.searchsorted(theta_r, theta_q) , 0, theta_r.size - 1)
    ring = np.where(
        (ring > 0)
        & (
            np.abs(theta_r[ring - 1] - theta_q)
            < np.abs(theta_r[np.minimum(ring, theta_r.size - 1)] - theta_q)
        ),
        ring - 1,
        np.minimum(ring, theta_r.size - 1),
    )
    n_r = nphi[ring]
    j = np.mod(np.rint((phi_q - phi0[ring]) * n_r / (2 * np.pi)), n_r).astype(int)
    out[disk] = m[start[ring] + j]
    return out


class Plot:
    """Queue panels with :meth:`add`, render with :meth:`output`."""

    def __init__(self):
        self._panels = []

    def add(self, obj, **kwargs):
        """Queue one panel.  `obj` may be: a 1-D array (line plot; a list
        of 1-D arrays overplots), a 2-D array (image), a HEALPix map
        (detected by pixel count; Mollweide), or ``(k, spectrum)`` tuples
        for log-log spectra via ``kwargs['kind']='loglog'``."""
        self._panels.append((obj, kwargs))

    def _render_panel(self, ax, obj, kw):
        import matplotlib.pyplot as plt

        title = kw.pop("title", None)
        kind = kw.pop("kind", None)
        label = kw.pop("label", None)

        def as_list(x):
            return x if isinstance(x, (list, tuple)) else [x]

        if kind == "loglog":
            pairs = obj
            if (
                isinstance(obj, tuple)
                and len(obj) == 2
                and not isinstance(obj[0], (list, tuple))
            ):
                pairs = [obj]  # a single (k, spectrum) pair
            for i, (k, s) in enumerate(pairs):
                lbl = label[i] if isinstance(label, (list, tuple)) else label
                ax.loglog(_np(k), _np(s), label=lbl, **kw)
            if label is not None:
                ax.legend()
        elif kind == "hist":
            ax.hist(np.ravel(_np(obj)), bins=kw.pop("bins", 50), **kw)
        else:
            arrs = [_np(a) for a in as_list(obj)]
            if arrs[0].ndim == 1:
                npix = arrs[0].size
                nside = int(np.sqrt(npix / 12.0)) if npix >= 12 else 0
                if nside > 0 and 12 * nside**2 == npix and npix > 12:
                    im = ax.imshow(
                        mollweide_grid_from_healpix(arrs[0]),
                        origin="lower",
                        **kw,
                    )
                    ax.set_axis_off()
                    plt.colorbar(im, ax=ax, shrink=0.7)
                else:
                    for i, a in enumerate(arrs):
                        lbl = (
                            label[i]
                            if isinstance(label, (list, tuple))
                            else label
                        )
                        ax.plot(a, label=lbl, **kw)
                    if label is not None:
                        ax.legend()
            elif arrs[0].ndim == 2:
                im = ax.imshow(arrs[0].T, origin="lower", **kw)
                plt.colorbar(im, ax=ax, shrink=0.7)
            elif arrs[0].ndim == 3:
                # multifrequency cube → colorimetric RGB panel
                ax.imshow(
                    np.transpose(rgb_from_spectral_cube(arrs[0]), (1, 0, 2)),
                    origin="lower",
                    **kw,
                )
                ax.set_axis_off()
            else:
                raise ValueError(f"cannot plot array of ndim {arrs[0].ndim}")
        if title:
            ax.set_title(title)

    def output(
        self,
        *,
        nx: Optional[int] = None,
        ny: Optional[int] = None,
        xsize: float = 6.0,
        ysize: float = 6.0,
        name: Optional[str] = None,
        show: bool = False,
    ):
        """Render all queued panels into one figure; save to `name` if
        given, optionally ``plt.show()``."""
        import matplotlib

        if name is not None and not show:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        n = len(self._panels)
        if n == 0:
            raise RuntimeError("nothing to plot")
        if nx is None and ny is None:
            nx = int(np.ceil(np.sqrt(n)))
            ny = int(np.ceil(n / nx))
        elif nx is None:
            nx = int(np.ceil(n / ny))
        elif ny is None:
            ny = int(np.ceil(n / nx))
        fig, axes = plt.subplots(
            ny, nx, figsize=(xsize * nx, ysize * ny), squeeze=False
        )
        for i, (obj, kw) in enumerate(self._panels):
            self._render_panel(axes[i // nx][i % nx], obj, dict(kw))
        for i in range(n, nx * ny):
            axes[i // nx][i % nx].set_axis_off()
        fig.tight_layout()
        if name is not None:
            fig.savefig(name)
        if show:
            plt.show()
        plt.close(fig)
        self._panels = []


# --- multifrequency RGB rendering ---------------------------------------------
#
# Published colorimetry: CIE-1931 2° color-matching functions (380–780 nm,
# 5 nm steps) and the sRGB/D65 conversion matrix.  A spectral cube
# (nfreq, ny, nx) is integrated against the matching functions and gamma-
# encoded — the physically-motivated false-color view of multifrequency
# sky reconstructions (reference behavior: ``nifty/cl/plot.py:64``).

# CIE 1931 standard observer, coarse 81-sample tabulation (x̄, ȳ, z̄)
_CIE_LAMBDA = np.linspace(380.0, 780.0, 81)


def _cie_xyz_bar():
    # Analytic multi-lobe Gaussian fits to the CIE 1931 color-matching
    # functions (Wyman, Sloan & Shirley 2013, JCGT 2:2) — accurate to ~1%
    # and free of large embedded tables.
    lam = _CIE_LAMBDA

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    xbar = (
        1.056 * g(lam, 599.8, 37.9, 31.0)
        + 0.362 * g(lam, 442.0, 16.0, 26.7)
        - 0.065 * g(lam, 501.1, 20.4, 26.2)
    )
    ybar = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(lam, 530.9, 16.3, 31.1)
    zbar = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(lam, 459.0, 26.0, 13.8)
    return np.stack([xbar, ybar, zbar])


_SRGB_D65 = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ]
)


def rgb_from_spectral_cube(cube):
    """Map a spectral cube ``(nfreq, ny, nx)`` to an sRGB image
    ``(ny, nx, 3)`` in [0, 1].

    Channels are spread uniformly over the visible band, integrated
    against the CIE-1931 matching functions, converted XYZ→linear sRGB
    (D65), normalized to the cube's peak luminance, and gamma-encoded.
    """
    cube = _np(cube).astype(np.float64)
    if cube.ndim != 3:
        raise ValueError("expected a (nfreq, ny, nx) spectral cube")
    nfreq = cube.shape[0]
    xyz_bar = _cie_xyz_bar()  # (3, 81)
    # resample the matching functions onto the cube's channels
    pos = np.linspace(0.0, _CIE_LAMBDA.size - 1.0, nfreq)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, _CIE_LAMBDA.size - 1)
    w = pos - lo
    cmf = (1.0 - w) * xyz_bar[:, lo] + w * xyz_bar[:, hi]  # (3, nfreq)
    cmf /= np.sum(cmf[1])  # normalize luminance response

    xyz = np.tensordot(cmf, np.maximum(cube, 0.0), axes=1)  # (3, ny, nx)
    rgb = np.tensordot(_SRGB_D65, xyz, axes=1)
    rgb = np.maximum(rgb, 0.0)
    peak = rgb.max()
    if peak > 0:
        rgb = rgb / peak
    # sRGB gamma encode
    lin = rgb <= 0.0031308
    rgb = np.where(lin, 12.92 * rgb, 1.055 * np.maximum(rgb, 1e-12) ** (1 / 2.4) - 0.055)
    return np.clip(np.moveaxis(rgb, 0, -1), 0.0, 1.0)
