"""User-facing reconstructor (counterpart of ``tomojax.api.TomoTPU``).

    from tomojax_torch import TomoTorch
    tomo = TomoTorch(tilt_angles_deg, tilt_series)   # device="cuda"
    tomo.fista(Niter=50, lambda_param=0.1)
    recon = tomo.get_recon()                         # (Nslice, Nray, Nray)
    tomo.asd_pocs(Niter=20)                          # or tomo.sart(Niter=20)

The tilt series is (Nslice, Nray, Nangles), as in the reference. Every
tensor lives on the device given at construction: there is no automatic
device choice, and device="cuda" on a machine without CUDA raises.

Slab-sharded runs (counterpart of ``TomoTPU(mesh=...)``): every rank
constructs ``TomoTorch(angles, series, group=g)`` with the whole series
and the `SlabGroup` of ``tomojax_torch.dist.init_distributed``, then makes
the same calls. Each rank keeps the slices of its z-slab; the solvers
exchange halo planes and all-reduce their scalars, and ``get_recon``
gathers the slabs (a collective: every rank calls it). When Nslice is not
a multiple of the group size, the slice axis is padded with zero slices at
the high end, as the JAX package pads it: the data term does not see the
padding, but the periodic TV wrap then couples slice Nslice - 1 to a zero
slice instead of slice 0, so TV-regularised results (fista, asd_pocs)
differ from the unsharded run near that boundary. For the same result as
one device, choose Nslice divisible by the group size.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch import tv as tvmod
from tomojax_torch.dist import (
    SlabGroup, gather_slabs, pad_slices, shard_global, unpad_slices,
)
from tomojax_torch.geometry import Geometry
from tomojax_torch.solvers import (
    AsdPocsParams,
    asd_pocs_host_loop,
    asd_pocs_run,
    data_distance_sl,
    fista_init_sl,
    fista_run_sl,
    from_sl,
    make_sart_weights,
    make_system,
    sart_sweep_sl,
    to_sl,
)


class TomoTorch:
    """Batched tilt-series reconstructor on one device, or on one z-slab
    per rank of a `SlabGroup`."""

    def __init__(self, tilt_angles_deg, tilt_series=None, device=None,
                 group: SlabGroup | None = None):
        """device: default "cuda". group: run slab-sharded over its ranks,
        on the group's device (then pass no device)."""
        if group is not None and device is not None:
            raise ValueError("pass a device or a group, not both: a group's "
                             "tensors live on group.device")
        self.group = group
        if device is None:
            device = "cuda" if group is None else group.device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TomoTorch(device='cuda'): torch finds no CUDA device; "
                "pass device='cpu' to run the plain PyTorch versions")
        self.tilt_angles = np.asarray(tilt_angles_deg, np.float64)
        self.recon = None
        self.cost = None
        self._sart_w = None
        # visiting orders of init='random' (the reference draws them from
        # jax.random.PRNGKey(0); the streams differ, the seed is the same)
        self._order_gen = torch.Generator().manual_seed(0)
        if tilt_series is not None:
            self.set_tilt_series(tilt_series)

    def set_tilt_series(self, tilt_series):
        """(Nslice, Nray, Nangles), tilt axis on dim 0."""
        ts = np.asarray(tilt_series, np.float32)
        if ts.ndim != 3 or ts.shape[2] != len(self.tilt_angles):
            raise ValueError(
                f"tilt series {ts.shape} must be (Nslice, Nray, Nangles) "
                f"with Nangles = {len(self.tilt_angles)}")
        self.Nslice, self.Nray, self.Nangles = ts.shape
        self.geom = Geometry.make(self.Nray, np.deg2rad(self.tilt_angles))
        self.sys = make_system(self.geom, self.device)
        # slice-last sinogram (Nangles, Nray, Nslice), or this rank's slab
        # of it after padding to a multiple of the group size
        b_sl = torch.from_numpy(np.ascontiguousarray(ts.transpose(2, 1, 0)))
        if self.group is None:
            self.b_sl = b_sl.to(self.device)
        else:
            self.b_sl = shard_global(pad_slices(b_sl, self.group, 2)[0],
                                     self.group, 2)
        self._sart_w = None
        self.restart_recon()

    def restart_recon(self):
        """Zero volume (this rank's slab with a group), public layout."""
        self.x = torch.zeros((self.b_sl.shape[2], self.Nray, self.Nray),
                             dtype=torch.float32, device=self.device)
        self.recon = None

    def fista(self, Niter: int = 100, momentum: bool = True,
              lambda_param: float = 0.1, nTViter: int = 10,
              show_convergence: bool = True, compat: str = "correct"):
        """FISTA-TV from zero (solvers/fista.py). With show_convergence,
        ``self.cost`` holds the per-iteration cost 0.5 dd^2 + lam tv,
        read from the device once at the end."""
        self.restart_recon()
        st = fista_init_sl(self.x, self.sys, self.b_sl)
        st, metrics = fista_run_sl(st, self.b_sl, self.sys, lambda_param,
                                   Niter, nTViter, momentum, compat,
                                   compute_metrics=show_convergence,
                                   group=self.group)
        self.cost = metrics[:, 0].cpu().numpy()
        self.x = from_sl(st.x)
        return self

    def sart(self, Niter: int = 150, init: str = "sequential",
             beta: float = 1.0, show_convergence: bool = True):
        """SART sweeps from zero (K8), 'sequential' or 'random' angle order.
        With show_convergence, ``self.cost`` holds ||A x - b|| after each
        sweep, read from the device once at the end."""
        init = self._check_init(init)
        self.restart_recon()
        w = self._sart_weights()
        beta_t = torch.tensor(beta, dtype=torch.float32, device=self.device)
        x = to_sl(self.x)
        orders = self._orders(init, Niter)
        dds = []
        for i in range(Niter):
            x = sart_sweep_sl(x, self.b_sl, self.geom, self.sys.inv_row, w,
                              beta_t, orders[i])
            if show_convergence:
                dds.append(data_distance_sl(x, self.b_sl, self.sys,
                                            self.group))
        self.cost = (torch.stack(dds).cpu().numpy() if dds
                     else np.zeros(Niter, np.float32))
        self.x = from_sl(x)
        return self

    def asd_pocs(self, Niter: int = 100, eps: float = 0.025,
                 beta0: float = 0.25, beta_reduce: float = 0.9985,
                 r_max: float = 0.95, nTViter: int = 10, alpha: float = 0.2,
                 alpha_reduce: float = 0.95, init: str = "sequential",
                 show_convergence: bool = True, fused: bool = False):
        """ASD-POCS from zero with the reference's working adaptation
        (solvers/asd_pocs.py). Sets ``dd_vec``, ``tv_vec`` and ``cost`` (=
        dd_vec); show_convergence is taken for the reference's signature,
        which records them always. The default host loop reads dp, dd and
        dg after every iteration and adapts beta and dpocs in Python, as
        the reference's driver does; fused=True carries them on the device
        (asd_pocs_run) and reads the metrics once at the end."""
        init = self._check_init(init)
        self.restart_recon()
        params = AsdPocsParams(
            niter=Niter, eps=eps, beta0=beta0, beta_red=beta_reduce,
            r_max=r_max, ng=nTViter, alpha=alpha, alpha_red=alpha_reduce)
        args = (to_sl(self.x), self.b_sl, self.sys, self._sart_weights(),
                params, self._orders(init, Niter), self.group)
        if fused:
            x, dd_vec, tv_vec = asd_pocs_run(*args)
            self.dd_vec = dd_vec.cpu().numpy()
            self.tv_vec = tv_vec.cpu().numpy()
        else:
            x, self.dd_vec, self.tv_vec, _ = asd_pocs_host_loop(*args)
        self.cost = self.dd_vec
        self.x = from_sl(x)
        return self

    def data_distance(self) -> float:
        """||A x - b|| of the current reconstruction (K1)."""
        return float(data_distance_sl(to_sl(self.x), self.b_sl, self.sys,
                                      self.group))

    def tv(self) -> float:
        """Periodic isotropic TV of the current reconstruction (K5)."""
        return float(tvmod.tv(to_sl(self.x), self.group))

    def get_recon(self) -> np.ndarray:
        """The reconstruction, (Nslice, Nray, Nray) float32 numpy; with a
        group the gathered slabs without the padding, on every rank."""
        if self.recon is None:
            x = self.x
            if self.group is not None:
                x = unpad_slices(gather_slabs(x, self.group), self.Nslice)
            self.recon = x.cpu().numpy()
        return self.recon

    @staticmethod
    def _check_init(init: str) -> str:
        if init not in ("sequential", "random"):
            print(f"{init} order not supported. Defaulting to sequential.")
            return "sequential"
        return init

    def _sart_weights(self) -> torch.Tensor:
        if self._sart_w is None:
            self._sart_w = make_sart_weights(self.sys)
        return self._sart_w

    def _orders(self, init: str, count: int) -> torch.Tensor:
        """(count, Na) int32 visiting orders on the device: arange rows, or
        permutations drawn from the instance's generator."""
        na = self.geom.nproj
        if init == "random":
            orders = torch.empty((count, na), dtype=torch.int32)
            for row in orders:
                row.copy_(torch.randperm(na, generator=self._order_gen))
        else:
            orders = torch.arange(na, dtype=torch.int32).expand(count, -1)
        return orders.to(self.device).contiguous()
