"""Visualization: convergence plots and volume viewers (counterpart of
``tomojax/viz.py``, of which this is a copy: the port keeps its own).

Replaces the reference's matplotlib scatter plots
(gpu/reconstructor.py:194-205), the 3-panel fusion cost plot
(chemistry/reconstructor.py:212-225) and the Tkinter volume viewers
(reconstructor.py:221-383) with headless-friendly matplotlib figures
(interactive windows appear when a display exists; otherwise pass `path=`
to save). Every entry point takes numpy arrays or tensors on any device
(copied to the host through ``.detach().cpu().numpy()``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """`a` as a numpy array: a tensor on any device is copied to the host."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _finish(fig, path: Optional[str]):
    import matplotlib.pyplot as plt

    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    plt.show()
    return fig


def plot_convergence(cost, algorithm: str = "", path: Optional[str] = None):
    """Scatter of cost vs iteration (reconstructor.py:194-205)."""
    import matplotlib

    if path:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    cost = _host(cost)
    fig = plt.figure(figsize=(8, 5))
    plt.scatter(np.arange(len(cost)), cost)
    plt.xlabel("Iteration")
    plt.ylabel("Cost")
    plt.title(f"{algorithm} Convergence".strip())
    if len(cost) > 1:
        plt.xlim([0, len(cost) - 1])
    plt.tick_params(direction="in", length=6, width=1.5, which="both",
                    top=True, right=True)
    return _finish(fig, path)


def plot_fusion_costs(cost_haadf, cost_chem, cost_tv,
                      path: Optional[str] = None):
    """3-panel fused-cost plot (chemistry/reconstructor.py:212-225)."""
    import matplotlib

    if path:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 6))
    labels = (
        r"$||A (\Sigma x) - b||^2$",
        r"$\sum (Ax - b \cdot \log(Ax))$",
        r"$\sum \|x\|_{TV}$",
    )
    for k, (data, lab) in enumerate(
        zip((cost_haadf, cost_chem, cost_tv), labels)
    ):
        ax = plt.subplot(3, 1, k + 1)
        ax.plot(_host(data))
        ax.set_ylabel(lab)
        ax.tick_params(direction="in", length=6, width=1.5, which="both",
                       top=True, right=True)
        if k < 2:
            ax.set_xticklabels([])
    plt.xlabel("# Iterations")
    return _finish(fig, path)


class VolumeViewer:
    """Interactive 3-plane slice viewer — parity with the reference's Tk
    volume viewers (gpu/reconstructor.py:221-383 and
    chemistry/reconstructor.py:251-382: three orthogonal planes, one
    scale/slider per plane to scrub through slices), redesigned on
    matplotlib Slider widgets so it runs on any matplotlib backend: an
    interactive window when a display exists, and fully scriptable
    headless (`set_slices` + `save`) — usable mid-run from the streaming
    loop the way the reference scrubs during dynamic experiments."""

    _PLANES = ("XY", "XZ", "YZ")

    def __init__(self, vol: np.ndarray, cmap: str = "gray"):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        self.vol = vol = _host(vol)
        assert vol.ndim == 3, f"expected a 3D volume, got {vol.shape}"
        self.fig, axes = plt.subplots(1, 3, figsize=(12, 4.8))
        self.fig.subplots_adjust(bottom=0.22)
        vmin, vmax = float(vol.min()), float(vol.max())
        self.idx = [s // 2 for s in vol.shape]
        self.ims = []
        self.sliders = []
        for k, ax in enumerate(axes):
            im = ax.imshow(self._plane(k, self.idx[k]), cmap=cmap,
                           vmin=vmin, vmax=vmax)
            ax.set_title(f"{self._PLANES[k]} view")
            ax.axis("off")
            self.ims.append(im)
            sax = self.fig.add_axes([0.13 + 0.28 * k, 0.08, 0.18, 0.03])
            s = Slider(sax, f"{self._PLANES[k]}", 0, vol.shape[k] - 1,
                       valinit=self.idx[k], valstep=1)
            s.on_changed(lambda v, k=k: self._update(k, int(v)))
            self.sliders.append(s)

    def _plane(self, k: int, i: int) -> np.ndarray:
        if k == 0:
            return self.vol[i]
        if k == 1:
            return self.vol[:, i, :]
        return self.vol[:, :, i]

    def _update(self, k: int, i: int):
        self.idx[k] = i
        self.ims[k].set_data(self._plane(k, i))
        self.fig.canvas.draw_idle()

    def set_slices(self, xy: Optional[int] = None, xz: Optional[int] = None,
                   yz: Optional[int] = None):
        """Programmatic scrubbing (drives the sliders, so the display
        and callbacks stay consistent)."""
        for k, v in enumerate((xy, xz, yz)):
            if v is not None:
                self.sliders[k].set_val(int(v))
        return self

    def set_volume(self, vol: np.ndarray):
        """Swap in a new volume at the current slice positions (live
        updates during a run, like the reference's dynamic dashboard)."""
        self.vol = _host(vol)
        for k in range(3):
            self.idx[k] = min(self.idx[k], self.vol.shape[k] - 1)
            self.ims[k].set_data(self._plane(k, self.idx[k]))
        self.fig.canvas.draw_idle()
        return self

    def save(self, path: str):
        self.fig.savefig(path, dpi=120, bbox_inches="tight")
        return path

    def show(self):
        import matplotlib.pyplot as plt

        plt.show()
        return self


def show_volume(vol: np.ndarray, path: Optional[str] = None,
                interactive: bool = False):
    """Three orthogonal slices (XY / XZ / YZ) of a volume.

    Default: static central-slice figure (saved to `path` or shown).
    interactive=True returns a `VolumeViewer` with one slice slider per
    plane — the Tk-viewer equivalent (reconstructor.py:221-383); when
    `path` is given the viewer's initial view is also saved."""
    import matplotlib

    if path:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if interactive:
        viewer = VolumeViewer(vol)
        if path:
            viewer.save(path)
        else:
            plt.show()
        return viewer

    vol = _host(vol)
    nx, ny, nz = vol.shape
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (img, title) in zip(
        axes,
        [
            (vol[nx // 2], "XY"),
            (vol[:, ny // 2, :], "XZ"),
            (vol[:, :, nz // 2], "YZ"),
        ],
    ):
        ax.imshow(img, cmap="gray")
        ax.set_title(f"{title} view")
        ax.axis("off")
    return _finish(fig, path)


class LiveMonitor:
    """Headless live dashboard for dynamic experiments — the matplotlib
    stand-in for the reference's pyqtgraph plotter (cpu/utils/plotter.py:
    recon slice, DD curve vs eps, sinogram, TV curve). Call `update(...)`
    each round; writes/refreshes a single PNG (or shows a window when a
    display exists)."""

    def __init__(self, path: Optional[str] = "live_monitor.png",
                 eps: Optional[float] = None):
        self.path = path
        self.eps = eps

    def update(self, recon, dd_history, sinogram=None, tv_history=None):
        import matplotlib

        if self.path:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        recon = _host(recon)
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        axes[0][0].imshow(recon[recon.shape[0] // 2], cmap="gray")
        axes[0][0].set_title("recon (central slice)")
        axes[0][0].axis("off")
        axes[0][1].plot(_host(dd_history))
        if self.eps is not None:
            axes[0][1].axhline(self.eps, color="r", ls="--", label="eps")
            axes[0][1].legend()
        axes[0][1].set_title("data distance")
        if sinogram is not None:
            axes[1][0].imshow(_host(sinogram), aspect="auto", cmap="gray")
            axes[1][0].set_title("sinogram (slice 0)")
        else:
            axes[1][0].axis("off")
        if tv_history is not None and len(tv_history):
            axes[1][1].plot(_host(tv_history))
            axes[1][1].set_title("TV")
        else:
            axes[1][1].axis("off")
        return _finish(fig, self.path)


def show_elements(vol4d: np.ndarray, elements: Sequence[str],
                  slice_idx: Optional[int] = None,
                  path: Optional[str] = None):
    """Side-by-side element maps at one slice
    (chemistry/reconstructor.py:251-382)."""
    import matplotlib

    if path:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    vol4d = _host(vol4d)
    nel = vol4d.shape[0]
    s = vol4d.shape[1] // 2 if slice_idx is None else slice_idx
    fig, axes = plt.subplots(1, nel, figsize=(4 * nel, 4), squeeze=False)
    for e in range(nel):
        axes[0][e].imshow(vol4d[e, s], cmap="inferno")
        axes[0][e].set_title(elements[e])
        axes[0][e].axis("off")
    return _finish(fig, path)
