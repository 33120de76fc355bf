"""Posterior plots: trace, density, running-mean, autocorrelation, bar,
contour, mixed — with multi-page grid drawing.

Counterpart of reference src/output/plot.jl (Gadfly engines,
plot.jl:83-226; grid/draw pagination, plot.jl:5-55) rebuilt on matplotlib.
``plot(c)`` returns a list of per-parameter figure-closure specs;
``draw(plots, ...)`` lays them out nrow x ncol per page and writes
svg/png/pdf files (one file per page, ``name-1.svg`` style, like the
reference's auto-extension mode).  SVG pages are written by this module
(``_SVGAxes`` records what the engines draw), the other formats by
matplotlib.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .chains import Chains
from .stats import autocov, cummean_arr

__all__ = ["plot", "draw", "traceplot", "densityplot", "meanplot",
           "autocorplot", "barplot", "contourplot", "mixeddensityplot"]


@dataclasses.dataclass
class PlotSpec:
    title: str
    render: Callable          # (ax) -> None


def _discrete_columns(c: Chains):
    v = c.value
    out = []
    for j in range(c.nparams):
        x = v[:, j, :]
        out.append(np.all(x == np.round(x)) and len(np.unique(x)) <= 25)
    return out


def traceplot(c: Chains, legend: bool = False):
    specs = []
    iters = c.range
    for j, name in enumerate(c.names):
        def render(ax, j=j):
            for k in range(c.nchains):
                ax.plot(iters, c.value[:, j, k], lw=0.5,
                        label=f"chain {c.chains[k]}")
            ax.set_xlabel("Iteration")
            ax.set_ylabel("Value")
            if legend:
                ax.legend(fontsize=6)
        specs.append(PlotSpec(c.names[j], render))
    return specs


def densityplot(c: Chains, legend: bool = False, trim=(0.025, 0.975)):
    specs = []
    for j, name in enumerate(c.names):
        def render(ax, j=j):
            from scipy.stats import gaussian_kde
            for k in range(c.nchains):
                x = c.value[:, j, k]
                lo, hi = np.quantile(x, trim)
                if hi <= lo:
                    ax.axvline(lo, label=f"chain {c.chains[k]}")
                    continue
                grid = np.linspace(lo, hi, 256)
                try:
                    ax.plot(grid, gaussian_kde(x)(grid),
                            label=f"chain {c.chains[k]}")
                except np.linalg.LinAlgError:
                    ax.axvline(x[0], label=f"chain {c.chains[k]}")
            ax.set_xlabel("Value")
            ax.set_ylabel("Density")
            if legend:
                ax.legend(fontsize=6)
        specs.append(PlotSpec(c.names[j], render))
    return specs


def meanplot(c: Chains, legend: bool = False):
    specs = []
    iters = c.range
    for j, name in enumerate(c.names):
        def render(ax, j=j):
            for k in range(c.nchains):
                ax.plot(iters, cummean_arr(c.value[:, j, k]),
                        label=f"chain {c.chains[k]}")
            ax.set_xlabel("Iteration")
            ax.set_ylabel("Mean")
            if legend:
                ax.legend(fontsize=6)
        specs.append(PlotSpec(c.names[j], render))
    return specs


def autocorplot(c: Chains, maxlag: int | None = None, legend: bool = False):
    specs = []
    n = c.niter
    maxlag = maxlag if maxlag is not None else int(round(10 * np.log10(n)))
    lags = np.arange(0, maxlag + 1)
    for j, name in enumerate(c.names):
        def render(ax, j=j):
            for k in range(c.nchains):
                g = autocov(c.value[:, j, k], lags)
                ax.plot(lags * c.thin, g / g[0],
                        label=f"chain {c.chains[k]}")
            ax.axhline(0.0, color="gray", lw=0.5)
            ax.set_xlabel("Lag")
            ax.set_ylabel("Autocorrelation")
            if legend:
                ax.legend(fontsize=6)
        specs.append(PlotSpec(c.names[j], render))
    return specs


def barplot(c: Chains, legend: bool = False, position: str = "stack"):
    specs = []
    for j, name in enumerate(c.names):
        def render(ax, j=j):
            width = 1.0 / c.nchains if position == "dodge" else 1.0
            bottoms = {}
            for k in range(c.nchains):
                x = c.value[:, j, k]
                levels, counts = np.unique(x, return_counts=True)
                props = counts / len(x)
                offs = (k - (c.nchains - 1) / 2) * width \
                    if position == "dodge" else 0.0
                bots = [bottoms.get(v, 0.0) for v in levels] \
                    if position == "stack" else None
                ax.bar(levels + offs, props, width=width * 0.9, bottom=bots,
                       label=f"chain {c.chains[k]}")
                if position == "stack":
                    for v, p in zip(levels, props):
                        bottoms[v] = bottoms.get(v, 0.0) + p
            ax.set_xlabel("Value")
            ax.set_ylabel("Density")
            if legend:
                ax.legend(fontsize=6)
        specs.append(PlotSpec(c.names[j], render))
    return specs


def contourplot(c: Chains, bins: int = 100):
    """Pairwise joint-density contours (reference contourplot,
    plot.jl:134-160)."""
    specs = []
    for i in range(c.nparams):
        for j in range(i + 1, c.nparams):
            def render(ax, i=i, j=j):
                x = c.value[:, i, :].ravel()
                y = c.value[:, j, :].ravel()
                H, xe, ye = np.histogram2d(x, y, bins=bins)
                ax.contour((xe[:-1] + xe[1:]) / 2, (ye[:-1] + ye[1:]) / 2,
                           H.T)
                ax.set_xlabel(c.names[i])
                ax.set_ylabel(c.names[j])
            specs.append(PlotSpec(f"{c.names[i]} vs {c.names[j]}", render))
    return specs


def mixeddensityplot(c: Chains, legend: bool = False, **kwargs):
    """Bar for discrete-valued parameters, density otherwise
    (plot.jl:202-208)."""
    disc = _discrete_columns(c)
    bars = barplot(c, legend=legend)
    dens = densityplot(c, legend=legend)
    return [bars[j] if disc[j] else dens[j] for j in range(c.nparams)]


_ENGINES = {
    "trace": traceplot, "density": densityplot, "mean": meanplot,
    "autocor": autocorplot, "bar": barplot, "contour": contourplot,
    "mixeddensity": mixeddensityplot,
}


def plot(c: Chains, ptype=("trace", "density"), legend: bool = False,
         **kwargs):
    """Grid of plots: one row per requested type, one column per parameter
    (reference plot, plot.jl:58-67).  Returns a flat row-major list of
    PlotSpecs for ``draw``."""
    if isinstance(ptype, str):
        ptype = [ptype]
    out = []
    for i, pt in enumerate(ptype):
        if pt not in _ENGINES:
            raise ValueError(f"unsupported plot type {pt!r}")
        showlegend = legend and i == len(ptype) - 1
        if pt == "contour":
            out.extend(_ENGINES[pt](c, **kwargs))
        else:
            out.extend(_ENGINES[pt](c, legend=showlegend, **kwargs))
    return out


_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
           "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")


class _SVGAxes:
    """The part of matplotlib's ``Axes`` that the plot engines call, kept
    as primitives in data coordinates and written as one SVG panel: lines,
    bars, rules, contour segments (marching squares), the title and the
    axis labels."""

    def __init__(self):
        self.lines, self.rects, self.segs = [], [], []
        self.vlines, self.hlines = [], []
        self.title = self.xlabel = self.ylabel = ""
        self.off = False
        self._series = 0

    def _color(self) -> str:
        """The next series' color (one per chain, as matplotlib cycles)."""
        self._series += 1
        return _COLORS[(self._series - 1) % len(_COLORS)]

    def plot(self, x, y, label=None, **kwargs):
        self.lines.append((np.asarray(x, float), np.asarray(y, float),
                           self._color()))

    def axvline(self, x, **kwargs):
        self.vlines.append(float(x))

    def axhline(self, y, **kwargs):
        self.hlines.append(float(y))

    def bar(self, x, height, width=0.8, bottom=None, label=None, **kwargs):
        x, h = np.atleast_1d(np.asarray(x, float)), np.atleast_1d(height)
        b = np.zeros_like(h) if bottom is None else np.asarray(bottom, float)
        color = self._color()
        self.rects.extend((xi - width / 2, bi, width, hi, color)
                          for xi, bi, hi in zip(x, b, h))

    def contour(self, X, Y, Z, levels: int = 6):
        Z = np.asarray(Z, float)
        for lev in np.linspace(Z.min(), Z.max(), levels + 2)[1:-1]:
            for i in range(Z.shape[0] - 1):
                for j in range(Z.shape[1] - 1):
                    self.segs.extend(_square_segments(X, Y, Z, i, j, lev))

    def set_title(self, s, **kwargs):
        self.title = s

    def set_xlabel(self, s):
        self.xlabel = s

    def set_ylabel(self, s):
        self.ylabel = s

    def legend(self, **kwargs):
        pass

    def axis(self, what):
        self.off = what == "off"

    def svg(self, x0, y0, w, h) -> str:
        """The panel at (x0, y0), w x h points."""
        if self.off:
            return ""
        xs = [a for a, _, _ in self.lines] + [np.array(self.vlines)]
        ys = [b for _, b, _ in self.lines] + [np.array(self.hlines)]
        for x, b, wd, ht, _ in self.rects:
            xs.append(np.array([x, x + wd]))
            ys.append(np.array([b, b + ht]))
        for seg in self.segs:
            xs.append(np.array(seg[0::2]))
            ys.append(np.array(seg[1::2]))
        xs, ys = np.concatenate(xs), np.concatenate(ys)
        xs, ys = xs[np.isfinite(xs)], ys[np.isfinite(ys)]
        lo_x, hi_x = (xs.min(), xs.max()) if xs.size else (0.0, 1.0)
        lo_y, hi_y = (ys.min(), ys.max()) if ys.size else (0.0, 1.0)
        hi_x, hi_y = max(hi_x, lo_x + 1e-12), max(hi_y, lo_y + 1e-12)
        L, T, R, B = x0 + 40, y0 + 18, x0 + w - 8, y0 + h - 28

        def px(v):
            return L + (np.asarray(v) - lo_x) / (hi_x - lo_x) * (R - L)

        def py(v):
            return B - (np.asarray(v) - lo_y) / (hi_y - lo_y) * (B - T)

        out = [f'<rect x="{L:.1f}" y="{T:.1f}" width="{R - L:.1f}" '
               f'height="{B - T:.1f}" fill="none" stroke="black"/>']
        for x, y, color in self.lines:
            pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px(x), py(y)))
            out.append(f'<polyline points="{pts}" fill="none" stroke-width="0.6" '
                       f'stroke="{color}"/>')
        for x, b, wd, ht, color in self.rects:
            top, bot = py(b + ht), py(b)
            out.append(f'<rect x="{px(x):.1f}" y="{top:.1f}" '
                       f'width="{px(x + wd) - px(x):.1f}" height="{bot - top:.1f}" '
                       f'fill="{color}"/>')
        for v in self.vlines:
            out.append(f'<line x1="{px(v):.1f}" y1="{T:.1f}" x2="{px(v):.1f}" '
                       f'y2="{B:.1f}" stroke="gray"/>')
        for v in self.hlines:
            out.append(f'<line x1="{L:.1f}" y1="{py(v):.1f}" x2="{R:.1f}" '
                       f'y2="{py(v):.1f}" stroke="gray"/>')
        for ax0, ay0, ax1, ay1 in self.segs:
            out.append(f'<line x1="{px(ax0):.1f}" y1="{py(ay0):.1f}" '
                       f'x2="{px(ax1):.1f}" y2="{py(ay1):.1f}" stroke="#1f77b4"/>')
        text = [(x0 + w / 2, y0 + 12, self.title, "middle", 9),
                ((L + R) / 2, y0 + h - 6, self.xlabel, "middle", 8),
                (L, B + 11, f"{lo_x:.4g}", "start", 7),
                (R, B + 11, f"{hi_x:.4g}", "end", 7),
                (L - 3, B, f"{lo_y:.4g}", "end", 7),
                (L - 3, T + 7, f"{hi_y:.4g}", "end", 7)]
        out += [f'<text x="{x:.1f}" y="{y:.1f}" font-size="{size}" '
                f'text-anchor="{anchor}">{_escape(t)}</text>'
                for x, y, t, anchor, size in text if t]
        out.append(f'<text transform="translate({x0 + 8:.1f},{(T + B) / 2:.1f}) '
                   f'rotate(-90)" font-size="8" text-anchor="middle">'
                   f'{_escape(self.ylabel)}</text>')
        return "\n".join(out)


def _escape(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def _square_segments(X, Y, Z, i, j, lev):
    """Marching squares: the pieces of the ``lev`` contour in the cell
    between grid points (i, j) and (i + 1, j + 1); ``Z`` is indexed
    [y, x] as matplotlib's ``contour`` takes it."""
    corners = [(X[j], Y[i], Z[i, j]), (X[j + 1], Y[i], Z[i, j + 1]),
               (X[j + 1], Y[i + 1], Z[i + 1, j + 1]), (X[j], Y[i + 1], Z[i + 1, j])]
    pts = []
    for (xa, ya, za), (xb, yb, zb) in zip(corners, corners[1:] + corners[:1]):
        if (za < lev) != (zb < lev):
            t = (lev - za) / (zb - za)
            pts.append((xa + t * (xb - xa), ya + t * (yb - ya)))
    return [(*pts[k], *pts[k + 1]) for k in range(0, len(pts) - 1, 2)]


def _draw_svg(plots, fname: str, nrow: int, ncol: int, width: float,
              height: float):
    w, h = 72.0 * width, 72.0 * height
    cw, ch = w / ncol, h / nrow
    panels = []
    for k, spec in enumerate(plots):
        ax = _SVGAxes()
        spec.render(ax)
        ax.set_title(spec.title)
        panels.append(ax.svg((k % ncol) * cw, (k // ncol) * ch, cw, ch))
    with open(fname, "w") as f:
        f.write(f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.0f}pt" '
                f'height="{h:.0f}pt" viewBox="0 0 {w:.0f} {h:.0f}" '
                f'font-family="sans-serif">\n'
                f'<rect width="100%" height="100%" fill="white"/>\n'
                + "\n".join(panels) + "\n</svg>\n")


def draw(plots, fmt: str = "svg", filename: str = "", nrow: int = 3,
         ncol: int = 2, width: float = 8.0, height: float = 8.0):
    """Render PlotSpecs in nrow x ncol pages (reference draw,
    plot.jl:5-55).  Returns the written filenames (or live matplotlib
    figures when no filename is given).  SVG files are written by this
    module itself, so they need no matplotlib (the hosts of GPU runs may
    lack it); png, pdf and ps pages are matplotlib's."""
    if fmt not in ("svg", "png", "pdf", "ps"):
        raise ValueError(f"unsupported draw format {fmt!r}")
    pp = nrow * ncol
    npages = int(np.ceil(len(plots) / pp))
    stem, has_ext = filename, "." in filename.rsplit("/", 1)[-1]

    def fname(page):
        return filename if has_ext and npages == 1 else f"{stem}-{page + 1}.{fmt}"

    if filename and fmt == "svg":
        for page in range(npages):
            _draw_svg(plots[page * pp: (page + 1) * pp], fname(page), nrow,
                      ncol, width, height)
        return [fname(page) for page in range(npages)]

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    outputs = []
    for page in range(npages):
        fig, axes = plt.subplots(nrow, ncol, figsize=(width, height))
        axes = np.atleast_1d(axes).ravel()
        chunk = plots[page * pp: (page + 1) * pp]
        for ax, spec in zip(axes, chunk):
            spec.render(ax)
            ax.set_title(spec.title, fontsize=9)
        for ax in axes[len(chunk):]:
            ax.axis("off")
        fig.tight_layout()
        if filename:
            fig.savefig(fname(page), format=fmt)
            plt.close(fig)
            outputs.append(fname(page))
        else:
            outputs.append(fig)
    return outputs
