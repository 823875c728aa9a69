"""WAN contention simulator — the ground truth the paper measures with
iPerf on AWS, reproduced as a max-min-fair water-filling model.

Resources:
  * per-DC NIC egress / ingress caps (WAN-throttled, §2.1)
  * per-path cap = bw_single(d) * KNEE_CONNS  (parallelism knee, §2.2)
  * per-connection cap = bw_single(d) (one TCP stream saturates at the
    single-connection BW for that distance)

A transfer session (i->j, c connections) contributes c identical flows.
Sharing is RTT-BIASED weighted max-min (progressive filling): a TCP
flow's share of a contended resource scales with 1/RTT (~1/distance) —
the paper's core premise that "nearby DCs occupy most of the available
network" (Fig. 2b), which heterogeneous connection counts counteract
(more flows on far links ~ more aggregate weight).

Measurement modes (paper §2.2):
  static-independent   one pair at a time, everything else idle
  static-simultaneous  all pairs at once (expensive: full-mesh iPerf)
  runtime              all pairs at once, during workload, w/ fluctuation
  snapshot             1-second runtime sample (extra observation noise)

Fluctuation follows an AR(1) log-normal per-link process ([38]'s
minutes-scale predictability).

Randomness is split into NAMED streams spawned from one seed
(fluctuation / observation / host), so the same network state yields
the same measurement regardless of call interleaving — the determinism
contract every replay of the control loop relies on.
Scripted dynamics hook in through `set_link_factor` (per-link scripted
degradation), `modulation` (global diurnal multiplier),
`background_conns` (cross-traffic that contends in the water-filling
but is never credited to the workload), and `set_provider_factor`
(provider migration, §3.3.3).

Multi-tenant sharing (the fleet): `set_tenant_conns` registers a
named tenant's connection matrix. Registered tenants CONTEND like
cross-traffic but, unlike `background_conns`, their share is CREDITED:
`waterfill(c, tenant=...)` excludes the caller's own registration (so
its in-flight matrix is not double-counted) while every other tenant's
flows fight it out in the same fill, and `waterfill_tenants` solves
ONE fill for the whole fleet and credits each tenant rate x own-conns.
Flows on the same pair share the pair's per-connection rate, so the
aggregate fill is exact, not an approximation.

This is the PyTorch port's copy of `repro/wan/simulator.py`. The
simulator is host numpy float64 in both packages, with the same named
`SeedSequence` streams, so every draw and every fill of the default
``"numpy"`` water-fill backend is bit-identical to the JAX package's.
The fill's other backends: ``"torch"``, the plain PyTorch version on
the host (`kernels/ref.py::fill_rates_ref`), and ``"cuda"``, the
hand-written kernel (`csrc/waterfill.cu`), one launch a fill, which
raises without a card; both agree with the host loop to 1e-9 with the
same iteration count (the JAX package's ``"jax"`` backend is the
batched `lax.while_loop` these replace). The overlay's routed fill
(`waterfill_routed`) takes the same dispatch: one fill of the expanded
connection matrix, on ``"cuda"`` one launch.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels import waterfill as wfk
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.wan import topology as topo

FILL_BACKENDS = ("numpy", "torch", "cuda")


class WaterfillDivergence(RuntimeError):
    """A progressive fill hit its iteration bound with unfrozen pairs
    left — the rates would be partial, so the fill fails loudly."""


def fill_rates_host(c: np.ndarray, single: np.ndarray, egress: np.ndarray,
                    ingress: np.ndarray, w: np.ndarray, path_cap: np.ndarray,
                    cap_iters: int) -> Tuple[np.ndarray, int, bool]:
    """The progressive water-fill on the host, numpy float64 — the
    bit-exact ``"numpy"`` backend the trace goldens pin.

    `c`, `single`, `w`, `path_cap` are [N,N] (aggregate flow counts,
    single-connection BW, per-connection RTT weights, knee path caps);
    `egress` / `ingress` [N] NIC caps. Returns ``(rate, iters,
    converged)``: per-connection rates [N,N], the iterations run, and
    False only if `cap_iters` iterations left pairs unfrozen.
    """
    N = c.shape[0]
    # every input of the fill is loop-invariant: the single-conn BW,
    # NIC caps, RTT weights (cached across fills), and the clipped
    # weight denominators are computed ONCE here, not per filling
    # iteration
    cw = c * w                                 # aggregate pair weight
    w_pos = w > 0
    cw_pos = cw > 0
    w_den = np.maximum(w, 1e-12)
    cw_den = np.maximum(cw, 1e-12)
    per_conn_cap = single                      # one stream's ceiling
    rate = np.zeros((N, N))                    # per-connection rate
    frozen = c <= 0
    iters = 0

    # progressive filling on the weighted fill level t:
    # rate_ij = t * w_ij while unfrozen
    while True:
        if frozen.all():
            break
        if iters >= cap_iters:
            return rate, iters, False
        act = ~frozen
        we = (cw * act).sum(axis=1)            # active weight per egress
        wi = (cw * act).sum(axis=0)
        head_e = egress - (rate * c).sum(axis=1)
        head_i = ingress - (rate * c).sum(axis=0)
        inc_e = np.where(we > 0, head_e / np.maximum(we, 1e-12), np.inf)
        inc_i = np.where(wi > 0, head_i / np.maximum(wi, 1e-12), np.inf)
        # per-pair bounds in fill-level units (rate grows as t*w)
        inc_conn = np.where(act & w_pos,
                            (per_conn_cap - rate) / w_den,
                            np.inf)
        inc_path = np.where(act & cw_pos,
                            (path_cap - rate * c) / cw_den,
                            np.inf)
        inc_pair = np.minimum(inc_conn, inc_path)
        inc = min(float(np.min(inc_e)), float(np.min(inc_i)),
                  float(np.min(inc_pair)))
        if not np.isfinite(inc) or inc < 1e-9:
            inc = 0.0
        rate = np.where(act, rate + inc * w, rate)
        hit = act & (((per_conn_cap - rate) < 1e-6) |
                     ((path_cap - rate * c) < 1e-6))
        tot_e = (rate * c).sum(axis=1)
        tot_i = (rate * c).sum(axis=0)
        sat_e = egress - tot_e < 1e-6
        sat_i = ingress - tot_i < 1e-6
        hit |= act & (sat_e[:, None] | sat_i[None, :])
        iters += 1
        if not hit.any() and inc == 0.0:
            break
        frozen |= hit
    return rate, iters, True


@dataclass
class WanSimulator:
    """The shared WAN ground truth (see module docstring)."""

    regions: List[str] = field(default_factory=lambda: list(topo.DEFAULT_8DC))
    # sustained WAN egress/ingress cap of a t2.medium-class worker;
    # calibrated so all-pairs contention reproduces Table 1 (18 pairs with
    # >100 Mbps static-vs-runtime gaps on the 8-DC mesh).
    nic_cap: float = 2600.0
    knee: float = topo.KNEE_CONNS
    seed: int = 0
    fluct_sigma: float = 0.12          # log-sd of slow link fluctuation
    fluct_rho: float = 0.9             # AR(1) coefficient
    snapshot_sigma: float = 0.08       # extra 1-second observation noise
    runtime_sigma: float = 0.015       # residual noise of 20 s averages
    # observation noise symmetric across i->j / j->i (links are modelled
    # symmetric in advance(); symmetric noise keeps a snapshot of a
    # symmetric network symmetric — see test_symmetric_obs_noise_default)
    symmetric_obs_noise: bool = True
    # per-DC VM multiplicity (association §3.3.3) and provider refactor
    vms_per_dc: Optional[np.ndarray] = None
    provider_factor: Optional[np.ndarray] = None
    # cross-traffic [N,N] connection counts: contend in waterfill, never
    # credited to the workload's achieved BW (scenario engine knob)
    background_conns: Optional[np.ndarray] = None
    # named tenants' [N,N] connection matrices: contend like cross-
    # traffic but their share IS credited (fleet arbitration)
    tenant_conns: Dict[str, np.ndarray] = field(default_factory=dict)
    # host-metric noise scale (mem/cpu normal sd; 0 additionally skips
    # the retransmission poisson, making host metrics DETERMINISTIC —
    # the operating mode of the deterministic fleet runs). Default
    # keeps the historical draws byte-identical.
    host_sigma: float = 0.02
    # water-fill backend: None defers to $REPRO_WATERFILL_BACKEND
    # (default "numpy", the bit-exact host loop the trace goldens pin);
    # "torch" runs the fill's plain PyTorch version on the host, "cuda"
    # the hand-written kernel on the card (both roundoff-equal)
    waterfill_backend: Optional[str] = None

    def __post_init__(self):
        self.N = len(self.regions)
        # named streams spawned from one seed: measurement draws do not
        # depend on how fluctuation/observation/host calls interleave
        s_fluct, s_obs, s_host = np.random.SeedSequence(self.seed).spawn(3)
        self.rng_fluct = np.random.default_rng(s_fluct)
        self.rng_obs = np.random.default_rng(s_obs)
        self.rng_host = np.random.default_rng(s_host)
        self.dist = topo.distance_matrix(self.regions)
        self._rebuild_base()
        self._fluct = np.zeros((self.N, self.N))   # log-space AR(1) state
        self._link_factor = np.ones((self.N, self.N))  # scripted events
        self.modulation = 1.0                      # scripted diurnal cycle
        # scripted reachability (fault plane): None = fully reachable
        # (the historical path — no mask is ever multiplied in); a bool
        # [N,N] mask zeroes unreachable links in link_bw_now()
        self._reachable: Optional[np.ndarray] = None
        # convergence accounting of the most recent / all fills (the
        # historical loop capped silently at 8*N*N; now surfaced) —
        # kept on the obs registry, read through `fill_calls` /
        # `last_fill_iters`
        self.metrics = MetricsRegistry("sim")
        self._m_fill_calls = self.metrics.counter(
            "fill_calls", help="water-fill invocations")
        self._m_last_iters = self.metrics.gauge(
            "last_fill_iters", help="iterations of the most recent fill")
        self._m_iters_total = self.metrics.counter(
            "fill_iters_total", help="cumulative fill iterations")
        self._m_iters_hist = self.metrics.histogram(
            "fill_iters", buckets=(4, 8, 16, 32, 64, 128, 256, 512),
            help="per-fill iteration distribution")

    @property
    def fill_iter_cap(self) -> int:
        """The fill's iteration bound (divergence past this raises)."""
        return 8 * self.N * self.N

    # -- fill accounting on the obs registry ---------------------------
    def _note_fill(self, iters: int) -> None:
        self._m_fill_calls.inc()
        self._m_last_iters.set(int(iters))
        self._m_iters_total.inc(int(iters))
        self._m_iters_hist.observe(int(iters))

    @property
    def fill_calls(self) -> int:
        """Total water-fill invocations (registry-backed)."""
        return int(self._m_fill_calls.value)

    @property
    def last_fill_iters(self) -> int:
        """Iterations of the most recent fill (registry-backed)."""
        return int(self._m_last_iters.value)

    def _rebuild_base(self) -> None:
        self.base = topo.bw_single_matrix(self.regions)
        if self.provider_factor is not None:
            pf = np.sqrt(np.outer(self.provider_factor, self.provider_factor))
            off = ~np.eye(self.N, dtype=bool)
            self.base[off] = (self.base * pf)[off]

    # ------------------------------------------------------------------
    # Scripted dynamics (scenario event targets)
    # ------------------------------------------------------------------
    def set_link_factor(self, i: int, j: int, factor: float) -> None:
        """Scripted symmetric degradation/restoration of one link
        (factor 1.0 = nominal; links are modelled symmetric)."""
        self._link_factor[i, j] = self._link_factor[j, i] = float(factor)

    def set_provider_factor(self, pf: Optional[np.ndarray]) -> None:
        """Provider migration (§3.3.3): rebuild base BW under new per-DC
        provider factors."""
        self.provider_factor = None if pf is None else np.asarray(pf, float)
        self._rebuild_base()

    def set_reachable(self, mask: Optional[np.ndarray]) -> None:
        """Scripted reachability (fault plane): `mask` is a bool [N,N]
        matrix; False pairs (a blacked-out DC, a network partition)
        carry ZERO bandwidth — not merely low BW, so a dead pair
        freezes at rate 0 in every fill and a solo measurement of it
        reads 0. None restores full reachability (and restores the
        exact historical arithmetic: no mask is multiplied in at all).
        The diagonal is forced True — a DC always reaches itself."""
        if mask is None:
            self._reachable = None
            return
        m = np.asarray(mask, bool).copy()
        if m.shape != (self.N, self.N):
            raise ValueError(f"reachability mask must be "
                             f"[{self.N},{self.N}], got {m.shape}")
        np.fill_diagonal(m, True)
        self._reachable = m

    def set_background(self, i: int, j: int, conns: float) -> None:
        """Cross-traffic on link i->j (0 clears)."""
        if self.background_conns is None:
            self.background_conns = np.zeros((self.N, self.N))
        self.background_conns[i, j] = float(conns)

    def set_tenant_conns(self, tenant: str, conns: np.ndarray) -> None:
        """Register tenant's [N,N] connection matrix (fleet workloads).

        Registered flows contend in every fill; pass ``tenant=`` to
        :meth:`waterfill` / the measure_* modes so the caller's own
        registration is excluded instead of double-counted.
        """
        c = np.asarray(conns, np.float64).copy()
        if c.shape != (self.N, self.N):
            raise ValueError(f"tenant conns must be [{self.N},{self.N}]")
        np.fill_diagonal(c, 0.0)
        self.tenant_conns[tenant] = np.maximum(c, 0.0)

    def clear_tenant(self, tenant: str) -> None:
        """Drop a tenant's registered flows (job departure)."""
        self.tenant_conns.pop(tenant, None)

    # ------------------------------------------------------------------
    def advance(self, steps: int = 1) -> None:
        """Advance the fluctuation process (call once per epoch/minute)."""
        for _ in range(steps):
            eps = self.rng_fluct.normal(0.0, self.fluct_sigma,
                                        (self.N, self.N))
            eps = (eps + eps.T) / 2                     # symmetric links
            self._fluct = self.fluct_rho * self._fluct + \
                np.sqrt(1 - self.fluct_rho ** 2) * eps

    def link_bw_now(self) -> np.ndarray:
        """Current single-connection BW per link (fluctuation x scripted
        link factors x diurnal modulation, zeroed on unreachable pairs
        when a fault-plane reachability mask is installed)."""
        bw = self.base * np.exp(self._fluct) * self._link_factor \
            * self.modulation
        if self._reachable is not None:
            bw = bw * self._reachable
        return bw

    def _caps(self):
        vms = self.vms_per_dc if self.vms_per_dc is not None \
            else np.ones(self.N)
        egress = self.nic_cap * vms
        ingress = self.nic_cap * vms
        return egress, ingress

    # ------------------------------------------------------------------
    # Max-min fair water-filling over all active (i,j) sessions
    # ------------------------------------------------------------------
    # TCP throughput ~ MSS/(RTT*sqrt(p)); under bursty WAN loss the
    # effective share skew is steeper than 1/RTT. beta=2 calibrated so
    # uniform-8 starves the far link at ~120 Mbps (paper Fig. 2b).
    rtt_beta: float = 2.0

    def rtt_weight(self) -> np.ndarray:
        """Per-connection contention weight ~ (1/RTT)^beta, normalized so
        the closest link has weight 1.

        Cached: the weight depends only on `dist` (fixed at
        construction and only ever replaced wholesale, never mutated in
        place) and `rtt_beta`, yet every water-fill used to rebuild it;
        the cache is invalidated when either changes."""
        cached = getattr(self, "_rtt_w_cache", None)
        if cached is not None and cached[0] is self.dist \
                and cached[1] == self.rtt_beta:
            return cached[2]
        d = np.maximum(self.dist, 1.0)
        w = (d[~np.eye(self.N, dtype=bool)].min() / d) ** self.rtt_beta
        np.fill_diagonal(w, 0.0)
        w.setflags(write=False)
        # key on the dist OBJECT (kept alive by the cache itself, so a
        # wholesale replacement can never alias its id) plus the beta
        self._rtt_w_cache = (self.dist, self.rtt_beta, w)
        return w

    def _contending_conns(self, own: np.ndarray,
                          tenant: Optional[str] = None) -> np.ndarray:
        """Aggregate flow count per pair: the caller's own flows plus
        uncredited cross-traffic plus every OTHER registered tenant
        (the caller's registration, named by `tenant`, is excluded so a
        tenant measuring at its in-force matrix is not double-counted).
        """
        c = own.copy()
        if self.background_conns is not None:
            bg = np.asarray(self.background_conns, np.float64).copy()
            np.fill_diagonal(bg, 0.0)
            c = c + np.maximum(bg, 0.0)            # cross-traffic contends
        for name, tc in self.tenant_conns.items():
            if name != tenant:
                c = c + tc                         # rival tenants contend
        return c

    def waterfill(self, conns: np.ndarray,
                  active: Optional[np.ndarray] = None,
                  cap: Optional[np.ndarray] = None,
                  tenant: Optional[str] = None) -> np.ndarray:
        """Achieved BW per pair [N,N] in Mbps for one workload.

        conns: [N,N] parallel connections per pair (0 or diag = idle).
        RTT-biased weighted progressive filling. `cap` is an optional
        per-pair BW ceiling — WANify's TC throttling of BW-rich links
        (Section 3.2.2). `tenant` names the caller so its own
        registered flows (see :meth:`set_tenant_conns`) are excluded
        from the contention aggregate.
        """
        own = np.asarray(conns, np.float64).copy()
        np.fill_diagonal(own, 0.0)
        if active is not None:
            own = own * active
        c = self._contending_conns(own, tenant)
        rate = self._fill_rates(c, cap)
        bw = rate * own              # uncredited traffic earns nothing
        np.fill_diagonal(bw, topo.INTRA_DC_BW)
        return bw

    def waterfill_routed(self, direct: np.ndarray,
                         relays: Sequence[Tuple[int, int, int, float]],
                         cap: Optional[np.ndarray] = None,
                         tenant: Optional[str] = None) -> np.ndarray:
        """Achieved END-TO-END BW per pair [N,N] for a routed workload
        (repro_torch.overlay): `direct` is the [N,N] direct-path
        connection matrix; each relay ``(i, k, j, conns)`` sends
        `conns` extra connections over the one-hop path i -> k -> j.

        Relay flows are charged on BOTH hops: the fill solves one
        expanded connection matrix in which a relay's connections
        appear on (i, k) AND (k, j), contending with every direct flow
        there (and with background / rival tenants, exactly like
        :meth:`waterfill`). Crediting is store-and-forward: each relay
        connection sustains ``min(rate[i,k], rate[k,j])`` — the
        bottleneck hop's per-connection rate — so a relay through a
        DC whose NIC is saturated buys nothing. The faster hop's
        surplus is NOT redistributed (conservative; the surplus decays
        as AIMD rebalances), and the credit lands on the end-to-end
        pair (i, j), which is what a shuffle/ring consumer observes.
        The fill itself is one `_fill_rates` call, so every fill
        backend serves it (``"cuda"``: one `waterfill` launch).
        """
        own = np.asarray(direct, np.float64).copy()
        np.fill_diagonal(own, 0.0)
        expanded = own.copy()
        for i, k, j, cr in relays:
            if i == j or cr <= 0:
                continue
            expanded[i, k] += cr
            expanded[k, j] += cr
        c = self._contending_conns(expanded, tenant)
        rate = self._fill_rates(c, cap)
        bw = rate * own
        for i, k, j, cr in relays:
            if i == j or cr <= 0:
                continue
            bw[i, j] += cr * min(float(rate[i, k]), float(rate[k, j]))
        np.fill_diagonal(bw, topo.INTRA_DC_BW)
        return bw

    def waterfill_tenants(self, conns_by_tenant: Dict[str, np.ndarray],
                          cap: Optional[np.ndarray] = None
                          ) -> Dict[str, np.ndarray]:
        """ONE fill for a whole fleet: all tenants' flows (plus any
        uncredited background) contend together, and each tenant is
        credited its per-connection rate x its own connection count.
        Exact because flows on the same pair share the pair's rate —
        and a single solve instead of one per job is what keeps the
        fleet tick sublinear in job count.

        The PASSED matrices are authoritative: a tenant mid-replan may
        price a candidate matrix that differs from its
        :meth:`set_tenant_conns` registration, and both the contention
        aggregate and the crediting use the candidate. (The historical
        add-every-registration-then-subtract form only netted out to
        this for exactly-representable counts; with fractional conns
        the float round-trip left contention and crediting disagreeing
        by roundoff — now the registration of a passed tenant never
        enters the aggregate at all.) Registered tenants NOT passed
        here still contend as uncredited rivals.
        """
        stack = {}
        for name, conns in conns_by_tenant.items():
            c = np.asarray(conns, np.float64).copy()
            np.fill_diagonal(c, 0.0)
            stack[name] = np.maximum(c, 0.0)
        total = np.zeros((self.N, self.N))
        for c in stack.values():
            total += c
        if self.background_conns is not None:
            bg = np.asarray(self.background_conns, np.float64).copy()
            np.fill_diagonal(bg, 0.0)
            total += np.maximum(bg, 0.0)           # cross-traffic contends
        for name, tc in self.tenant_conns.items():
            if name not in stack:
                total += tc                        # rival tenants contend
        rate = self._fill_rates(total, cap)
        out = {}
        for name, c in stack.items():
            bw = rate * c
            np.fill_diagonal(bw, topo.INTRA_DC_BW)
            out[name] = bw
        return out

    def _fill_backend(self) -> str:
        """Resolve the fill backend: the instance field wins, then
        ``$REPRO_WATERFILL_BACKEND``, then the bit-exact numpy loop."""
        b = self.waterfill_backend or \
            os.environ.get("REPRO_WATERFILL_BACKEND", "numpy")
        if b not in FILL_BACKENDS:
            raise ValueError(f"unknown waterfill backend {b!r}; "
                             f"expected one of {FILL_BACKENDS}")
        return b

    def fill_inputs(self, cap: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, np.ndarray]:
        """The fill's loop-invariant inputs at the CURRENT network
        state: ``(single, egress, ingress, w, path_cap)`` — the
        single-connection BW, NIC caps, RTT weights (cached across
        fills) and the knee path cap (min'd with any §3.2.2 `cap`).
        Computed once per fill, for whichever backend runs it."""
        single = self.link_bw_now()
        egress, ingress = self._caps()
        w = self.rtt_weight()                      # per-connection weight
        path_cap = single * self.knee              # parallelism knee
        if cap is not None:
            path_cap = np.minimum(path_cap, np.asarray(cap, np.float64))
        return single, egress, ingress, w, path_cap

    def _fill_rates(self, c: np.ndarray,
                    cap: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-connection rate [N,N] for an aggregate flow matrix `c`
        (diagonal ignored; every flow on a pair gets the same rate).

        Converges within `fill_iter_cap` iterations or raises
        :class:`WaterfillDivergence`; the actual iteration count is
        surfaced on ``last_fill_iters`` (and ``fill_calls`` counts
        fills) so harnesses can assert convergence headroom.
        """
        single, egress, ingress, w, path_cap = self.fill_inputs(cap)
        backend = self._fill_backend()
        if backend == "numpy":
            rate, iters, ok = fill_rates_host(c, single, egress, ingress, w,
                                              path_cap, self.fill_iter_cap)
        else:
            rate, iters, ok = wfk.fill_rates(
                c, single, egress, ingress, w, path_cap,
                device="cuda" if backend == "cuda" else "cpu")
        self._note_fill(int(iters))
        if not bool(ok):
            raise WaterfillDivergence(
                f"{backend} water-fill hit the {self.fill_iter_cap}-"
                f"iteration bound with unfrozen pairs left")
        return rate

    # ------------------------------------------------------------------
    # Measurement modes
    # ------------------------------------------------------------------
    def measure_static_independent(self, conns_per_pair: int = 1,
                                   tenant: Optional[str] = None
                                   ) -> np.ndarray:
        """One pair at a time (existing GDA systems' iPerf methodology).

        With the network otherwise idle, a solo pair's fill has a
        closed form — the progressive filling freezes it in one step at
        the tightest of its four constraints — so the historical
        N(N-1)-waterfill loop collapses to one vectorized expression:

            bw_ij = min(single_ij * c,            # per-connection cap
                        single_ij * knee,         # parallelism knee
                        egress_i, ingress_j)      # NIC caps

        computed with the exact arithmetic of the filling loop (the
        min of the loop's fill-level quotients times ``w * c``), so it
        equals the loop BIT-FOR-BIT — `tests/test_simulator.py` pins
        that on the 8-DC mesh. Cross-traffic or RIVAL registered
        tenants would contend even with a solo measurement pair, so
        those cases fall back to the per-pair fills.

        `tenant` names the caller like in every other measure_* mode:
        its own :meth:`set_tenant_conns` registration is excluded, so
        a registered tenant measuring static-independent sees the solo
        closed form (or self-excluded fills) instead of double-
        counting its in-force flows as rival traffic.
        """
        N = self.N
        bg = self.background_conns
        rivals = any(name != tenant for name in self.tenant_conns)
        if rivals or (bg is not None and (np.asarray(bg) > 0).any()):
            out = np.full((N, N), topo.INTRA_DC_BW)
            for i in range(N):
                for j in range(N):
                    if i == j:
                        continue
                    c = np.zeros((N, N))
                    c[i, j] = conns_per_pair
                    out[i, j] = self.waterfill(c, tenant=tenant)[i, j]
            return out
        single = self.link_bw_now()
        egress, ingress = self._caps()
        w = self.rtt_weight()
        c = float(conns_per_pair)
        w_den = np.maximum(w, 1e-12)
        cw_den = np.maximum(c * w, 1e-12)
        # the loop's fill level: min over the four binding constraints,
        # in fill-level units (rate grows as t * w)
        inc = np.minimum(
            np.minimum(single / w_den, (single * self.knee) / cw_den),
            np.minimum(egress[:, None] / cw_den, ingress[None, :] / cw_den))
        inc = np.where(np.isfinite(inc) & (inc >= 1e-9), inc, 0.0)
        out = (inc * w) * c
        np.fill_diagonal(out, topo.INTRA_DC_BW)
        return out

    def measure_simultaneous(self, conns: Optional[np.ndarray] = None,
                             noise: float = 0.0,
                             cap: Optional[np.ndarray] = None,
                             tenant: Optional[str] = None) -> np.ndarray:
        """All pairs at once (runtime / static-simultaneous)."""
        N = self.N
        c = np.ones((N, N)) if conns is None else np.asarray(conns, float)
        bw = self.waterfill(c, cap=cap, tenant=tenant)
        if noise > 0:
            off = ~np.eye(N, dtype=bool)
            eps = self.rng_obs.normal(0, noise, (N, N))
            if self.symmetric_obs_noise:
                # /sqrt(2) keeps the per-link marginal sd at `noise`
                eps = (eps + eps.T) / np.sqrt(2.0)
            bw = np.where(off, bw * np.exp(eps), bw)
        return bw

    def measure_runtime(self, conns: Optional[np.ndarray] = None,
                        cap: Optional[np.ndarray] = None,
                        tenant: Optional[str] = None) -> np.ndarray:
        """Stable >=20 s all-pairs measurement (small residual noise)."""
        return self.measure_simultaneous(conns, noise=self.runtime_sigma,
                                         cap=cap, tenant=tenant)

    def measure_snapshot(self, conns: Optional[np.ndarray] = None,
                         tenant: Optional[str] = None) -> np.ndarray:
        """Cheap 1-second sample: same ground truth, more noise."""
        return self.measure_simultaneous(conns, noise=self.snapshot_sigma,
                                         tenant=tenant)

    # ------------------------------------------------------------------
    def host_metrics(self, conns: np.ndarray, bw: Optional[np.ndarray] = None,
                     tenant: Optional[str] = None):
        """Simulated node metrics for Table-3 features:
        mem_util[j] (receiver buffers scale with incoming connections),
        cpu_load[i] (sender), retrans[i,j] (congestion proxy)."""
        c = np.asarray(conns, float).copy()
        np.fill_diagonal(c, 0)
        if bw is None:
            bw = self.waterfill(c, tenant=tenant)
        total_in = c.sum(axis=0)
        total_out = c.sum(axis=1)
        # host_sigma == 0 skips every host draw (normal AND poisson):
        # fully deterministic node metrics
        mem_eps = cpu_eps = 0.0
        poisson = 0.0
        if self.host_sigma > 0:
            mem_eps = self.rng_host.normal(0, self.host_sigma, self.N)
            cpu_eps = self.rng_host.normal(0, self.host_sigma, self.N)
            poisson = self.rng_host.poisson(1.0, (self.N, self.N))
        mem_util = np.clip(0.15 + 0.02 * total_in + mem_eps, 0.05, 0.98)
        cpu_load = np.clip(0.10 + 0.015 * total_out + cpu_eps, 0.02, 0.98)
        # retransmissions rise when a pair is squeezed below its solo BW
        solo = self.link_bw_now()
        squeeze = np.maximum(0.0, 1.0 - bw / np.maximum(solo * c, 1e-9))
        retrans = np.rint(squeeze * 40 + poisson).astype(float)
        np.fill_diagonal(retrans, 0)
        return mem_util, cpu_load, retrans
