"""User-facing reconstructors (counterparts of ``tomojax.api.TomoTPU`` and
``tomojax.api.ChemicalTomo``).

    from tomojax_torch import TomoTorch
    tomo = TomoTorch(tilt_angles_deg, tilt_series)   # device="cuda"
    tomo.fista(Niter=50, lambda_param=0.1)
    recon = tomo.get_recon()                         # (Nslice, Nray, Nray)
    tomo.asd_pocs(Niter=20)     # or .sart, .sirt, .kl_divergence,
                                # .cgls, .art, .wbp

    from tomojax_torch import Simulator
    sim = Simulator(volume, tilt_angles_deg, snr=200)  # noisy projections
    sim.sirt(Niter=10).rmse()                  # against the phantom

    from tomojax_torch import ChemicalTomo
    chem = ChemicalTomo(haadf, haadf_angles_deg, {"c": c_series, ...},
                        chem_angles_deg)             # device="cuda"
    chem.chemical_tomography(Niter=50).data_fusion(Niter=50)
    recon = chem.get_recon()                  # (Nel, Nslice, Nray, Nray)
    chem.display_recon("elements.png")        # tomo.show_recon(path),
                                              # tomo.plot_convergence(path)

The tilt series is (Nslice, Nray, Nangles), as in the reference. Every
tensor lives on the device given at construction: there is no automatic
device choice, and device="cuda" on a machine without CUDA raises.

Slab-sharded runs (counterpart of ``TomoTPU(mesh=...)`` and
``ChemicalTomo(mesh=...)``): every rank constructs ``TomoTorch(angles,
series, group=g)`` or ``ChemicalTomo(..., group=g)`` with the whole series
and the `SlabGroup` of ``tomojax_torch.dist.init_distributed``, then makes
the same calls. Each rank keeps the slices of its z-slab; the solvers
exchange halo planes and all-reduce their scalars, and ``get_recon``
gathers the slabs (a collective: every rank calls it, as it calls the
plotting methods, which gather first). When Nslice is not
a multiple of the group size, the slice axis is padded with zero slices at
the high end, as the JAX package pads it: the data term does not see the
padding, but the periodic TV wrap then couples slice Nslice - 1 to a zero
slice instead of slice 0, so TV-regularised results (fista, asd_pocs,
data_fusion) differ from the unsharded run near that boundary. For the
same result as one device, choose Nslice divisible by the group size.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch import host, ops, profiling, viz
from tomojax_torch import tv as tvmod
from tomojax_torch.dist import (
    SlabGroup, all_reduce_max, all_reduce_sum, gather_slabs, slab,
    unpad_slices,
)
from tomojax_torch.fusion import (
    data_fusion_run,
    data_fusion_step,
    make_fusion_system,
    poisson_ml_step_4d,
    rescale_projections,
    rescale_tomograms,
    weights_for_elements,
)
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import fp_sl
from tomojax_torch.projector.filters import FILTERS
from tomojax_torch.sim import create_projections
from tomojax_torch.solvers import (
    AsdPocsParams,
    art_sweep_sl,
    asd_pocs_host_loop,
    asd_pocs_run,
    cgls_run_sl,
    data_distance_sl,
    fbp_sl,
    fista_init_sl,
    fista_run_sl,
    from_sl,
    make_sart_weights,
    make_system,
    poisson_ml_step_sl,
    row_norms_sq,
    sart_sweep_sl,
    sirt_sweep_sl,
    to_sl,
)
from tomojax_torch.tv import tv_fgp_4d

# Spans (`profiling.annotate`; recorded only while a torch profiler runs):
# one root per public call that does device work ("api.<class>" around a
# construction, "api.<method>" around a solver method or get_recon), and
# inside it "api.h2d" (the series' copy to the device in the caller's
# layout), "api.sinogram" (the layout change and normalisation on the
# device), "api.system" (the projector's system and weights), the
# solvers' "solvers.iteration", and the spans of the reads, which `host`
# opens (`host.to_host`, `host.read_scalars`). "api.h2d" counts
# "series_host_copies": the series numpy had to copy before the device
# copy.


class TomoTorch:
    """Batched tilt-series reconstructor on one device, or on one z-slab
    per rank of a `SlabGroup`."""

    @profiling.spanned("api.TomoTorch")
    def __init__(self, tilt_angles_deg, tilt_series=None, device=None,
                 group: SlabGroup | None = None):
        """device: default "cuda". group: run slab-sharded over its ranks,
        on the group's device (then pass no device)."""
        self.group = group
        self.device = host.device(device, group, "TomoTorch")
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
        with profiling.annotate("api.h2d"):
            ts = host.host_series(tilt_series)
            if ts.ndim != 3 or ts.shape[2] != len(self.tilt_angles):
                raise ValueError(
                    f"tilt series {ts.shape} must be (Nslice, Nray, "
                    f"Nangles) with Nangles = {len(self.tilt_angles)}")
            self.Nslice, self.Nray, self.Nangles = ts.shape
            series = host.series_to_device([ts], ts.shape, self.device,
                                           self.group)[0]
        # slice-last sinogram (Nangles, Nray, Nslice), or this rank's slab
        # of it after padding to a multiple of the group size
        with profiling.annotate("api.sinogram"):
            self.b_sl = series.permute(2, 1, 0).contiguous()
        with profiling.annotate("api.system"):
            self.geom = Geometry.make(self.Nray,
                                      np.deg2rad(self.tilt_angles))
            self.sys = make_system(self.geom, self.device)
        self._sart_w = None
        self.restart_recon()

    def restart_recon(self):
        """Zero volume (this rank's slab with a group), public layout."""
        self.x = torch.zeros((self.b_sl.shape[2], self.Nray, self.Nray),
                             dtype=torch.float32, device=self.device)
        self.recon = None

    def update_projection_angles(self, tilt_angles_deg, tilt_series):
        """Rebind the angles and the data (dynamic acquisition: the
        reference's tomoengine.cpp:130-149 grows its geometry). The current
        reconstruction is kept as the warm start when the number of slices
        is unchanged."""
        x_prev = getattr(self, "x", None)
        ns_prev = getattr(self, "Nslice", None)
        self.tilt_angles = np.asarray(tilt_angles_deg, np.float64)
        self.set_tilt_series(tilt_series)
        if x_prev is not None and ns_prev == self.Nslice:
            self.x = x_prev
        return self

    @profiling.spanned("api.wbp")
    def wbp(self, filter: str = "ram-lak", apply_positivity: bool = True):
        """Filtered backprojection (solvers/wbp.py); an unknown filter name
        is reported and replaced by ram-lak, as the reference does."""
        if filter not in FILTERS:
            print(f"{filter} filter not supported. Defaulting to ram-lak.")
            filter = "ram-lak"
        self.x = from_sl(fbp_sl(self.b_sl, self.geom, filter,
                                apply_positivity))
        self.recon = None
        return self

    @profiling.spanned("api.fista")
    def fista(self, Niter: int = 100, momentum: bool = True,
              lambda_param: float = 0.1, nTViter: int = 10,
              show_convergence: bool = True, compat: str = "correct",
              fused: bool = False):
        """FISTA-TV from zero (solvers/fista.py). With show_convergence,
        ``self.cost`` holds the per-iteration cost 0.5 dd^2 + lam tv,
        read from the device once at the end. fused is taken for the
        reference's signature, where it scans the iterations into one
        traced program: the slice-last loop here never waits for the
        host inside the loop, so both values run it."""
        self.restart_recon()
        st = fista_init_sl(self.x, self.sys, self.b_sl)
        st, metrics = fista_run_sl(st, self.b_sl, self.sys, lambda_param,
                                   Niter, nTViter, momentum, compat,
                                   compute_metrics=show_convergence,
                                   group=self.group)
        self.cost = host.to_host(metrics[:, 0])
        self.x = from_sl(st.x)
        return self

    @profiling.spanned("api.sart")
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
        self.cost = (host.to_host(torch.stack(dds)) if dds
                     else np.zeros(Niter, np.float32))
        self.x = from_sl(x)
        return self

    @profiling.spanned("api.art")
    def art(self, Niter: int = 1, beta: float = 1.0,
            random_order: bool = False, show_convergence: bool = True):
        """Ray-by-ray Kaczmarz sweeps from zero (A1), rays angle-major or,
        with random_order (randART), a permutation of the Na Nt rays drawn
        each sweep from the instance's generator (the reference draws from
        jax.random.PRNGKey(0): the seed is the same, the stream differs).
        With show_convergence, ``self.cost`` holds ||A x - b|| after each
        sweep, read from the device once at the end."""
        self.restart_recon()
        rays = self.geom.nproj * self.geom.nray
        x = to_sl(self.x)
        dds = []
        for _ in range(Niter):
            order = (torch.randperm(rays, generator=self._order_gen)
                     if random_order else torch.arange(rays))
            order = order.to(device=self.device, dtype=torch.int32)
            x = art_sweep_sl(x, self.b_sl, self.geom, beta, order)
            if show_convergence:
                dds.append(data_distance_sl(x, self.b_sl, self.sys,
                                            self.group))
        self.cost = (host.to_host(torch.stack(dds)) if dds
                     else np.zeros(Niter, np.float32))
        self.x = from_sl(x)
        return self

    @profiling.spanned("api.cgls")
    def cgls(self, Niter: int = 100, show_convergence: bool = True):
        """CGLS from zero (per-slice scalars, K1 and K2), positivity after
        the run; with show_convergence ``self.cost`` holds the one data
        distance after it."""
        self.restart_recon()
        x = torch.clamp_min(cgls_run_sl(to_sl(self.x), self.b_sl, self.sys,
                                        Niter), 0.0)
        if show_convergence:
            dd = data_distance_sl(x, self.b_sl, self.sys, self.group)
            self.cost = np.asarray([float(host.to_host(dd))])
        self.x = from_sl(x)
        return self

    @profiling.spanned("api.sirt")
    def sirt(self, Niter: int = 150, show_convergence: bool = True,
             variant: str = "astra"):
        """SIRT from zero, one `sirt_sweep_sl` iteration at a time; variant
        'astra' (K1 and K2's fused update), 'landweber' or 'cimmino'. With
        show_convergence, ``self.cost`` holds ||A x - b|| after each
        iteration, read from the device once at the end."""
        self.restart_recon()
        row_nsq = (row_norms_sq(self.geom, self.device)
                   if variant == "cimmino" else None)
        x = to_sl(self.x)
        dds = []
        for _ in range(Niter):
            x = sirt_sweep_sl(x, self.b_sl, self.sys, 1, variant,
                              row_nsq=row_nsq)
            if show_convergence:
                dds.append(data_distance_sl(x, self.b_sl, self.sys,
                                            self.group))
        self.cost = (host.to_host(torch.stack(dds)) if dds
                     else np.zeros(Niter, np.float32))
        self.x = from_sl(x)
        return self

    @profiling.spanned("api.kl_divergence")
    def kl_divergence(self, Niter: int = 100, lambda_param: float = 0.1):
        """Poisson-ML from zero on a copy of the data normalised to max 1;
        the reconstruction is scaled back to data units afterwards and the
        stored data are untouched (as ``TomoTPU.kl_divergence``).
        ``self.cost`` holds the KL cost of each iteration, read once at
        the end. With a group the maximum is the whole sinogram's and the
        cost the sum over the slabs (one all-reduce each); the pad slices
        carry b = 0, so x stays 0 there and they add 0 to the cost."""
        self.restart_recon()
        bmax = torch.max(self.b_sl)
        if self.group is not None:
            all_reduce_max(bmax, self.group)
        bmax = float(host.to_host(bmax))
        b_kl = self.b_sl / bmax if bmax > 0 else self.b_sl
        x = to_sl(self.x)
        costs = []
        for _ in range(Niter):
            x, c = poisson_ml_step_sl(x, b_kl, self.sys, lambda_param)
            costs.append(c)
        if costs:
            cost = torch.stack(costs)
            if self.group is not None:
                all_reduce_sum(cost, self.group)
            self.cost = host.to_host(cost)
        else:
            self.cost = np.zeros(Niter, np.float32)
        self.x = from_sl(x * bmax if bmax > 0 else x)
        return self

    @profiling.spanned("api.asd_pocs")
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
            self.dd_vec = host.to_host(dd_vec)
            self.tv_vec = host.to_host(tv_vec)
        else:
            x, self.dd_vec, self.tv_vec, _ = asd_pocs_host_loop(*args)
        self.cost = self.dd_vec
        self.x = from_sl(x)
        return self

    def data_distance(self) -> float:
        """||A x - b|| of the current reconstruction (K1)."""
        return float(host.to_host(data_distance_sl(to_sl(self.x), self.b_sl,
                                                   self.sys, self.group)))

    def tv(self) -> float:
        """Periodic isotropic TV of the current reconstruction (K5)."""
        return float(host.to_host(tvmod.tv(to_sl(self.x), self.group)))

    def lipschitz(self) -> float:
        return float(host.to_host(self.sys.lipschitz))

    def _whole(self, a: torch.Tensor, axis: int) -> torch.Tensor:
        """`a`, sliced on `axis`, as the whole array without the padding:
        with a group the slabs gathered on every rank (a collective)."""
        if self.group is None:
            return a
        return unpad_slices(gather_slabs(a, self.group, axis), self.Nslice,
                            axis)

    @profiling.spanned("api.get_recon")
    def get_recon(self) -> np.ndarray:
        """The reconstruction, (Nslice, Nray, Nray) float32 numpy; with a
        group the gathered slabs without the padding, on every rank."""
        if self.recon is None:
            self.recon = host.to_host(self._whole(self.x, 0))
        return self.recon

    def get_projections(self) -> np.ndarray:
        """The measured sinogram (Nslice, Nangles, Nray) (the reference's
        sinogram layout, not the tilt series'); a collective with a
        group."""
        return host.to_host(from_sl(self._whole(self.b_sl, 2)))

    def get_model_projections(self) -> np.ndarray:
        """A x of the current reconstruction (K1), (Nslice, Nangles, Nray);
        a collective with a group."""
        ax = fp_sl(to_sl(self.x), self.geom)
        return host.to_host(from_sl(self._whole(ax, 2)))

    def plot_convergence(self, path: str | None = None):
        """Scatter of ``self.cost`` against the iteration (`viz`); saved to
        `path`, or shown."""
        return viz.plot_convergence(self.cost, path=path)

    def show_recon(self, path: str | None = None):
        """The three central planes of the reconstruction (`viz`); a
        collective with a group (it gathers the slabs)."""
        return viz.show_volume(self.get_recon(), path=path)

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


class Simulator(TomoTorch):
    """Simulation-study driver (counterpart of ``tomojax.api.Simulator``,
    the reference's gpu/simulator.py): projects a ground-truth volume
    (Nslice, N, N) with K1 on the device, with Poisson noise at count
    level `snr` (drawn on the host from seed 0) where snr != 0, and
    reconstructs from those projections with every TomoTorch method.

    With snr, `original` becomes the background-filled volume (zero voxels
    set to 1) and `rmse` compares against it, as the reference does. With
    a group every rank projects the whole volume and TomoTorch then keeps
    its slab of the sinogram, as the reference builds the sinogram
    unsharded."""

    def __init__(self, volume, tilt_angles, snr: int = 0, device=None,
                 group: SlabGroup | None = None):
        self.original = np.asarray(volume, np.float32)
        if snr:
            self.original = np.where(self.original == 0, np.float32(1.0),
                                     self.original).astype(np.float32)
        n = self.original.shape[1]
        dev = host.device(device, group, "Simulator")
        geom = Geometry.make(n, np.deg2rad(np.asarray(tilt_angles,
                                                      np.float64)))
        self._truth = torch.from_numpy(self.original).to(dev)
        b = create_projections(self._truth, geom, snr=snr)
        super().__init__(tilt_angles,
                         b.permute(0, 2, 1).contiguous().cpu().numpy(),
                         device=device, group=group)

    def rmse(self) -> float:
        """Root-mean-square error of the reconstruction against
        `original` (with a group over all ranks' real slices, an
        all-reduce)."""
        if self.group is None:
            return float(host.to_host(ops.rmse(self.x, self._truth)))
        s = slab(self.Nslice, self.group)
        d = self.x[:s.real] - self._truth[s.lo:s.lo + s.real]
        sq = all_reduce_sum(torch.sum(d * d), self.group)
        return float(host.to_host(torch.sqrt(sq / self._truth.numel())))


class ChemicalTomo:
    """Fused multi-modal reconstructor on one device, or on one z-slab per
    rank of a `SlabGroup` (counterpart of ``tomojax.api.ChemicalTomo``, the
    reference's chemistry/reconstructor.py).

    haadf: the HAADF tilt series (Nslice, Nray, NaH); chem: element symbol
    -> its tilt series (Nslice, Nray, NaC); angles in degrees. Both are
    clamped to >= 0 and normalised to max 1 (on the device), as the
    reference does. The state lives slice-last on `device` (default
    "cuda", which raises where torch finds no CUDA): x (Nel, Nray, Nray,
    Nslice), the sinograms (NaH, Nray, Nslice) and (Nel, NaC, Nray,
    Nslice).

    With a group (then no device), every rank passes the whole series and
    keeps its slab of each stack: the slice axis is padded with zero slices
    to a multiple of the group size, as the reference pads it on a mesh,
    and cut into one slab per rank. The costs are all-reduced, so every
    rank reads the same values and takes the same lambdaCHEM decay;
    `get_recon`, `rmse_per_element` and `display_recon` gather the slabs
    (collectives) and drop the padding."""

    @profiling.spanned("api.ChemicalTomo")
    def __init__(self, haadf, haadfTiltAngles, chem: dict, chemTiltAngles,
                 gamma: float = 1.6, sigmaMethod: int = 3, device=None,
                 group: SlabGroup | None = None):
        self.group = group
        self.device = host.device(device, group, "ChemicalTomo")
        with profiling.annotate("api.h2d"):
            haadf = host.host_series(haadf)
            if haadf.ndim != 3 or haadf.shape[2] != len(haadfTiltAngles):
                raise ValueError(f"haadf {haadf.shape} must be (Nslice, "
                                 f"Nray, NaH) with NaH = "
                                 f"{len(haadfTiltAngles)}")
            h = host.series_to_device([haadf], haadf.shape, self.device,
                                      group)
        self.nx, self.ny, _ = haadf.shape
        self.elements = list(chem)
        self.nel = len(self.elements)
        self.gamma, self.sigmaMethod = gamma, sigmaMethod
        self.reduceLambda = True
        want = (self.nx, self.ny, len(chemTiltAngles))
        with profiling.annotate("api.h2d"):
            maps = []
            for el in self.elements:
                maps.append(host.host_series(chem[el]))
                if maps[-1].shape != want:
                    raise ValueError(
                        f"chem[{el!r}] {maps[-1].shape}, expected {want}")
            c = host.series_to_device(maps, want, self.device, group)
        # clamped to >= 0, each series over its maximum (over every slab:
        # one all-reduce with a group), then slice-last
        with profiling.annotate("api.sinogram"):
            h.clamp_min_(0)
            c.clamp_min_(0)
            peak = torch.cat([h.amax(dim=(1, 2, 3)), c.amax(dim=(1, 2, 3))])
            if group is not None:
                all_reduce_max(peak, group)
            peak = peak.clamp_min_(1e-30)[:, None, None, None]
            self.b_haadf = (h / peak[:1])[0].permute(2, 1, 0).contiguous()
            self.b_chem = (c / peak[1:]).permute(0, 3, 2, 1).contiguous()
        with profiling.annotate("api.system"):
            self.fsys = make_fusion_system(
                self.ny, np.deg2rad(np.asarray(haadfTiltAngles, np.float64)),
                np.deg2rad(np.asarray(chemTiltAngles, np.float64)),
                weights_for_elements(self.elements, gamma, sigmaMethod),
                gamma, self.device)
        self.x = torch.zeros((self.nel, self.ny, self.ny,
                              self.b_haadf.shape[2]),
                             dtype=torch.float32, device=self.device)
        self.reconTotal = None
        self.chemistry_reconstructed = False

    def restart_recon(self):
        self.x = torch.zeros_like(self.x)
        self.reconTotal = None

    @profiling.spanned("api.chemical_tomography")
    def chemical_tomography(self, Niter: int = 100,
                            lambdaCHEM: float = 0.05,
                            show_convergence: bool = True):
        """Chemistry-only Poisson-ML from zero (reconstructor.py:157-180).
        ``self.costCHEM`` holds each iteration's KL cost, read from the
        device once at the end (no decision depends on it)."""
        self.restart_recon()
        costs = []
        for _ in range(Niter):
            with profiling.annotate("solvers.iteration"):
                self.x, c = poisson_ml_step_4d(self.x, self.b_chem,
                                               self.fsys, lambdaCHEM,
                                               self.group)
            costs.append(c)
        self.costCHEM = (host.to_host(torch.stack(costs)) if costs
                         else np.zeros(Niter, np.float32))
        self.chemistry_reconstructed = True
        self.reconTotal = None
        return self

    def _rescale_data(self, scale: float = 10.0):
        """reconstructor.py:227-236."""
        self.x = rescale_tomograms(self.x, scale)
        self.b_haadf = rescale_projections(self.x, self.b_haadf, self.fsys,
                                           self.group)

    @profiling.spanned("api.data_fusion")
    def data_fusion(self, Niter: int = 50, lambdaCHEM: float = 5e-2,
                    lambdaHAADF: float = 10.0, lambdaTV: float = 1e-4,
                    iterSIRT: int = 5, tvIter: int = 5,
                    show_convergence: bool = True,
                    normalize_haadf: bool = False, method: str = "sirt",
                    fused: bool = False):
        """The fused reconstruction loop (reconstructor.py:182-225): the
        fusion step, the per-element FGP and lambdaCHEM *= 0.95 whenever
        the HAADF cost rose. The default host loop reads the three costs
        after every iteration and decides the decay in Python, as the
        reference does; fused=True runs `data_fusion_run`, which carries
        lambdaCHEM on the device and reads the costs once at the end.
        Sets costHAADF, costCHEM and costTV. method 'sirt' or 'sart' picks
        the inner HAADF solver (for 'sart' iterSIRT counts sweeps)."""
        if not self.chemistry_reconstructed:
            self.chemical_tomography(lambdaCHEM=lambdaCHEM,
                                     show_convergence=show_convergence)
        self._rescale_data()
        sart_w = (make_sart_weights(self.fsys.haadf) if method == "sart"
                  else None)
        if fused:
            self.x, metrics = data_fusion_run(
                self.x, self.b_haadf, self.b_chem, self.fsys, lambdaHAADF,
                lambdaCHEM, Niter, iterSIRT, tvIter, lambdaTV,
                self.reduceLambda, normalize_haadf, method, sart_w,
                self.group)
            m = host.to_host(metrics)
        else:
            m = np.zeros((Niter, 3), np.float32)
            lam_chem = lambdaCHEM
            for i in range(Niter):
                with profiling.annotate("solvers.iteration"):
                    self.x, ch, cc = data_fusion_step(
                        self.x, self.b_haadf, self.b_chem, self.fsys,
                        lambdaHAADF, lam_chem, iterSIRT, normalize_haadf,
                        method, sart_w, self.group)
                    self.x, tv0 = tv_fgp_4d(self.x, tvIter, lambdaTV,
                                            group=self.group)
                    m[i] = host.read_scalars(ch, cc, tv0)
                    if (self.reduceLambda and i > 0
                            and m[i, 0] > m[i - 1, 0]):
                        lam_chem *= 0.95
        self.costHAADF, self.costCHEM, self.costTV = m[:, 0], m[:, 1], m[:, 2]
        self.reconTotal = None
        return self

    def _whole(self) -> torch.Tensor:
        """The state (Nel, Nray, Nray, Nslice) without the padding: with a
        group the slabs gathered on every rank (a collective)."""
        if self.group is None:
            return self.x
        return unpad_slices(gather_slabs(self.x, self.group, 3), self.nx, 3)

    def rmse_per_element(self, ground_truth) -> np.ndarray:
        """Per-element RMSE against the (Nel, Nslice, Nray, Nray) ground
        truth; a collective with a group."""
        gt = torch.as_tensor(np.asarray(ground_truth, np.float32),
                             device=self.device)
        return host.to_host(ops.rmse_per_element(from_sl(self._whole()), gt))

    @profiling.spanned("api.get_recon")
    def get_recon(self) -> np.ndarray:
        """(Nel, Nslice, Nray, Nray) float32 numpy
        (reconstructor.py:238-249); with a group the gathered slabs without
        the padding, on every rank."""
        if self.reconTotal is None:
            self.reconTotal = host.to_host(from_sl(self._whole()))
        return self.reconTotal

    def display_recon(self, path: str | None = None):
        """Each element's map at the central slice side by side (`viz`);
        a collective with a group (it gathers the slabs)."""
        return viz.show_elements(self.get_recon(), self.elements, path=path)
