"""Plotting utilities (the port's own copy of
``naviflow_tpu/postprocessing/visualization.py``): the velocity field,
streamlines, the three-panel combined-results figure with the Ghia
centreline comparison, and the final-residual panels with the residual
histories.  Host-side matplotlib (Agg) on numpy arrays; staggered fields
are averaged to cell centres.

matplotlib is imported when a plot is made, not with this module: the
card's machine may not have it, and then a plot raises ``ImportError``
saying what to install.
"""

from __future__ import annotations

import os

import numpy as np

from .validation import get_ghia_data


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib: pip install matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _centered(u, v):
    """Average staggered u, v to cell centres."""
    uc = 0.5 * (u[:-1, :] + u[1:, :])
    vc = 0.5 * (v[:, :-1] + v[:, 1:])
    return uc, vc


def _save_or_show(fig, filename):
    if filename:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fig.savefig(filename, dpi=150, bbox_inches="tight")
        _plt().close(fig)
        return filename
    return fig


def plot_velocity_field(u, v, mesh, filename=None, title="Velocity field"):
    """Velocity-magnitude pcolormesh with a quiver overlay."""
    plt = _plt()
    uc, vc = _centered(np.asarray(u), np.asarray(v))
    X, Y = mesh.meshgrid()
    mag = np.hypot(uc, vc)
    fig, ax = plt.subplots(figsize=(6, 5))
    pc = ax.pcolormesh(X, Y, mag, shading="auto", cmap="viridis")
    s = max(1, mesh.nx // 24)
    ax.quiver(X[::s, ::s], Y[::s, ::s], uc[::s, ::s], vc[::s, ::s], color="w", width=0.002)
    fig.colorbar(pc, ax=ax, label="|u|")
    ax.set(title=title, xlabel="x", ylabel="y", aspect="equal")
    return _save_or_show(fig, filename)


def plot_streamlines(u, v, mesh, filename=None, title="Streamlines"):
    """Streamlines over the velocity magnitude."""
    plt = _plt()
    uc, vc = _centered(np.asarray(u), np.asarray(v))
    fig, ax = plt.subplots(figsize=(6, 5))
    mag = np.hypot(uc, vc)
    pc = ax.pcolormesh(*mesh.meshgrid(), mag, shading="auto", cmap="viridis")
    # streamplot wants (ny, nx) row-major over x
    ax.streamplot(mesh.x, mesh.y, uc.T, vc.T, color="w", density=1.2, linewidth=0.7)
    fig.colorbar(pc, ax=ax, label="|u|")
    ax.set(title=title, xlabel="x", ylabel="y", aspect="equal",
           xlim=(0, mesh.length), ylim=(0, mesh.height))
    return _save_or_show(fig, filename)


def plot_combined_results_matrix(result, filename=None):
    """Three panels: velocity magnitude, streamlines over pressure, and the
    centreline profiles against Ghia."""
    plt = _plt()
    mesh = result.mesh
    u, v, p = result.u, result.v, result.p
    uc, vc = _centered(u, v)
    X, Y = mesh.meshgrid()
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.6))

    pc0 = axes[0].pcolormesh(X, Y, np.hypot(uc, vc), shading="auto", cmap="viridis")
    fig.colorbar(pc0, ax=axes[0], label="|u|")
    axes[0].set(title="Velocity magnitude", aspect="equal")

    pc1 = axes[1].pcolormesh(X, Y, p, shading="auto", cmap="coolwarm")
    axes[1].streamplot(mesh.x, mesh.y, uc.T, vc.T, color="k", density=1.0, linewidth=0.6)
    fig.colorbar(pc1, ax=axes[1], label="p")
    axes[1].set(title="Streamlines over pressure", aspect="equal")

    nx, ny = mesh.get_dimensions()
    axes[2].plot(u[nx // 2, :], mesh.y, "b-", label="u(x=0.5)")
    axes[2].plot(mesh.x, v[:, ny // 2], "g-", label="v(y=0.5)")
    if result.reynolds is not None:
        ghia = get_ghia_data(result.reynolds)
        axes[2].plot(ghia["u"], ghia["y"], "bo", mfc="none", label="Ghia u")
        axes[2].plot(ghia["x"], ghia["v"], "gs", mfc="none", label="Ghia v")
    axes[2].legend(fontsize=8)
    axes[2].set(title=f"Centerlines vs Ghia (Re={result.reynolds})", xlabel="u / x",
                ylabel="y / v")
    axes[2].grid(alpha=0.3)

    fig.suptitle(f"{getattr(result, 'algorithm', 'SIMPLE')}  {nx}x{ny}  "
                 f"iters={result.iterations}")
    return _save_or_show(fig, filename)


def plot_final_residuals(result, filename=None):
    """Residual-field panels and the residual histories."""
    plt = _plt()
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    fields = [("u residual", result.u_residual_field), ("v residual", result.v_residual_field),
              ("p residual", result.p_residual_field)]
    for ax, (name, f) in zip(axes[0], fields):
        if f is None:
            ax.axis("off")
            continue
        pc = ax.pcolormesh(np.abs(f).T, shading="auto", cmap="magma")
        fig.colorbar(pc, ax=ax)
        ax.set_title(name)
    ax = axes[1][0]
    if result.residuals.size:
        ax.semilogy(result.residuals)
    ax.set(title="Total residual history", xlabel="iteration", ylabel="residual")
    ax.grid(alpha=0.3)
    for name, style in (("u_rel_norm", "b-"), ("v_rel_norm", "g-"), ("p_rel_norm", "r-")):
        h = result.get_history(name)
        if h is not None and h.size:
            axes[1][1].semilogy(h, style, label=name)
    axes[1][1].legend(fontsize=8)
    axes[1][1].set(title="Per-equation residuals", xlabel="iteration")
    axes[1][1].grid(alpha=0.3)
    h = result.get_history("pressure_inner_iterations")
    if h is not None and h.size:
        axes[1][2].plot(h)
    axes[1][2].set(title="Pressure inner iterations", xlabel="outer iteration")
    axes[1][2].grid(alpha=0.3)
    return _save_or_show(fig, filename)
