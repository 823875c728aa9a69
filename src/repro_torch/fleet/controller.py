"""FleetController — N concurrent WANify jobs over ONE shared WAN.

The paper evaluates one workload at a time (§5); a production fleet
runs many, and their transfers contend on the same inter-DC links —
exactly the "dynamic and simultaneous transfer among DCs" regime
static measurement gets wrong. The fleet controller closes that gap:

* every job is a full :class:`WanifyController` over its own topology
  slice (a :class:`TenantView` of the shared simulator), with its own
  skew weights and priority;
* before any job plans, the :mod:`arbiter` splits the per-host
  connection budget and contended-link capacity into per-job
  :class:`BudgetEnvelope`s by priority-weighted fair share;
* each tick captures every job's snapshot (rival tenants contending —
  and credited), stacks the feature rows, and launches the RF kernel
  ONCE for the whole fleet (:class:`BatchedRfPredictor`);
* achieved BW is solved with ONE fleet-wide water-fill
  (`waterfill_tenants`) and credited per tenant, with each job's
  envelope cap applied as TC shaping;

A fleet tick is one arbitration epoch (the paper's 5-second local-
optimizer cadence, fleet-wide): all active jobs replan together so the
batched kernel launch and the single water-fill amortize across jobs —
per-tick cost grows sublinearly in job count (benchmarks/fleet_bench).

Job arrival bootstraps its controller's init plan from the snapshot-
as-prediction ablation (no RF launch), under an envelope arbitrated at
arrival — the one-launch-per-tick invariant holds through churn.

Port of `repro/fleet/controller.py`: the same host numpy control
plane around the CUDA forest kernel, so tick records equal the JAX
package's. Not yet ported, and raising `NotImplementedError`: the
fault plane (``faults="on"`` or a plane object), placement planners
(`job_planner`) and the fused one-program tick (`fused`/`run_fused`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.control import ControllerConfig, WanifyController
from repro_torch.core.predictor import SnapshotPredictor, matrix_from_pairs
from repro_torch.faults.plane import faults_mode
from repro_torch.fleet import arbiter
from repro_torch.fleet.predictor import BatchedRfPredictor
from repro_torch.fleet.tenant import TenantView
from repro_torch.obs.spans import NULL_TRACER, SpanTracer, obs_mode
from repro_torch.wan.simulator import WanSimulator, WaterfillDivergence
from repro_torch.wan.topology import INTRA_DC_BW


@dataclass(frozen=True)
class JobSpec:
    """One fleet job: a workload slice with a priority.

    `dcs` are global indices into the shared mesh (order = the job's
    pod numbering); `priority` weights every fair-share split;
    `skew_w` is the job's own §3.3.1 data-skew vector (len == len(dcs)).
    """
    name: str
    dcs: Tuple[int, ...]
    priority: float = 1.0
    skew_w: Optional[Tuple[float, ...]] = None


class FleetJob:
    """Runtime state of one admitted job."""

    def __init__(self, spec: JobSpec, view: TenantView,
                 controller: Optional[WanifyController]):
        """Built by :meth:`FleetController.add_job`; not user-facing."""
        self.spec = spec
        self.view = view
        self.controller = controller
        self.priority = float(spec.priority)

    @property
    def name(self) -> str:
        """The job's fleet-unique name (its tenant id on the mesh)."""
        return self.spec.name

    def skew(self) -> Optional[np.ndarray]:
        """The job's skew weights as an array (None = uniform)."""
        if self.spec.skew_w is None:
            return None
        return np.asarray(self.spec.skew_w, np.float64)


class FleetController:
    """Arbitrate one shared WAN across N concurrent WANify jobs."""

    def __init__(self, sim: WanSimulator, predictor: BatchedRfPredictor,
                 m_total: int = 8, jobs: Tuple[JobSpec, ...] = (),
                 obs: Optional[str] = None, faults: Any = None):
        """`m_total` is the per-host connection budget the whole fleet
        shares at each DC; `predictor` serves every job's RF inference
        in one launch per tick. `obs` gates span tracing (repro_torch.obs;
        None defers to $REPRO_OBS, default off) — passive either way.
        `faults` gates the fault plane (the mode resolves via
        $REPRO_FAULTS, default off); the plane is not yet ported, so
        ``"on"`` or a plane object raises."""
        self.sim = sim
        self.predictor = predictor
        self.m_total = int(m_total)
        self.jobs: Dict[str, FleetJob] = {}
        self.tick_count = 0
        self.events: List[str] = []
        self.tracer = NULL_TRACER
        if obs_mode(obs) == "on":
            self.tracer = SpanTracer()
            self.tracer.watch(self.sim.metrics)
            self.tracer.watch(self.predictor.metrics)
        if (faults is not None and not isinstance(faults, str)) \
                or faults_mode(faults) == "on":
            raise NotImplementedError("the fault plane is not yet ported")
        for spec in jobs:
            self.add_job(spec)

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def add_job(self, spec: JobSpec) -> FleetJob:
        """Admit a job: arbitrate envelopes for the grown fleet, then
        bootstrap its controller (snapshot-ablation init plan, no RF
        launch) and register its flows on the shared mesh."""
        if spec.name in self.jobs:
            raise ValueError(f"job {spec.name!r} already in fleet")
        if len(spec.dcs) < 2:
            raise ValueError(
                f"job {spec.name!r} spans {len(spec.dcs)} DC(s); a fleet "
                f"job needs >= 2 (a single DC has no WAN pairs to plan)")
        view = TenantView(self.sim, spec.name, spec.dcs)
        job = FleetJob(spec, view, controller=None)
        self.jobs[spec.name] = job
        envs = self._arbitrate()
        cfg = ControllerConfig(max_conns=self.m_total, advance_sim=False)
        # overlay pinned off: the arbiter splits budgets and credits
        # achieved BW over DIRECT per-pair flows; a job routing through
        # a relay would consume a third DC's share the envelopes don't
        # model (fleet-level overlay is future work), so a global
        # $REPRO_OVERLAY=on must not leak into fleet jobs
        ctl = WanifyController(sim=view, predictor=SnapshotPredictor(),
                               n_pods=view.N, cfg=cfg,
                               envelope=envs[spec.name], overlay="off")
        # the job's internal replan stages (optimize/aimd) show up in
        # the fleet's span tree; its registry joins the delta watch
        # under a per-job namespace so jobs don't clobber each other
        ctl.metrics.namespace = f"job.{spec.name}"
        ctl.tracer = self.tracer
        if self.tracer.enabled:
            self.tracer.watch(ctl.metrics)
        job.controller = ctl
        view.register(ctl.current_conns())
        self.events.append(f"job {spec.name} arrived "
                           f"(dcs={list(spec.dcs)}, prio={job.priority})")
        return job

    def remove_job(self, name: str) -> None:
        """Withdraw a job's flows and drop it; survivors re-arbitrate
        at the next tick (their envelopes grow into the freed share)."""
        job = self.jobs.pop(name)
        job.view.unregister()
        self.events.append(f"job {name} departed")

    def set_priority(self, name: str, priority: float) -> None:
        """Shift a job's weight; takes effect at the next arbitration."""
        self.jobs[name].priority = float(priority)
        self.events.append(f"job {name} priority -> {priority}")

    def job_planner(self, name: str, query, **kwargs):
        """Placement planners are not yet ported."""
        raise NotImplementedError("placement planners (job_planner) are "
                                  "not yet ported")

    # ------------------------------------------------------------------
    # the arbitrated, batched fleet tick
    # ------------------------------------------------------------------
    def capacity_estimate(self) -> np.ndarray:
        """Per-link saturation capacity [N,N] to arbitrate: a 1-second
        single-connection probe under the fleet's current load, scaled
        by the parallelism knee (§2.2)."""
        probe = self.sim.measure_snapshot(np.ones((self.sim.N, self.sim.N)))
        return probe * self.sim.knee

    def _arbitrate(self) -> Dict[str, Any]:
        """Compute and install one envelope per job (slice-scale cap)."""
        triples = [(j.name, j.spec.dcs, j.priority)
                   for j in self.jobs.values()]
        envs = arbiter.arbitrate(triples, self.sim.N, self.m_total,
                                 self.capacity_estimate())
        sliced = {}
        for job in self.jobs.values():
            env = envs[job.name]
            env = type(env)(max_conns=env.max_conns,
                            link_cap=job.view.extract(env.link_cap))
            sliced[job.name] = env
            if job.controller is not None:
                job.controller.set_envelope(env)
        return sliced

    def tick(self, advance: bool = True) -> Dict[str, Any]:
        """One arbitration epoch. Returns a structured record (the
        fleet trace row body; see fleet/trace.py).

        Order per tick: advance simulated time -> arbitrate envelopes
        -> capture every job (batched features) -> ONE RF launch ->
        per-job replan inside its envelope -> register new flows ->
        ONE fleet-wide water-fill for credited achieved BW.
        """
        tr = self.tracer
        self.tick_count += 1
        with tr.span("tick", tick=self.tick_count):
            if advance:
                self.sim.advance()
            with tr.span("arbitrate"):
                envs = self._arbitrate()

            # capture first, all jobs, against LAST tick's registered
            # flows
            with tr.span("capture"):
                captures = []
                for job in self.jobs.values():
                    conns = job.controller.current_conns()
                    X, raw = job.controller.monitor.capture(conns)
                    captures.append((job, X, raw))
            rows: List[Dict[str, Any]] = []
            if captures:
                with tr.span("predict", delta=True):
                    X_all = np.vstack([X for _, X, _ in captures])
                    vals = self.predictor.predict_rows(X_all)  # ONE launch
                    parts = self.predictor.split_rows(
                        vals, [len(X) for _, X, _ in captures])
                with tr.span("replan", delta=True):
                    for (job, _, raw), v in zip(captures, parts):
                        P = job.controller.n_pods
                        pred = matrix_from_pairs(v, P, diag=INTRA_DC_BW)
                        job.controller.replan(
                            skew_w=job.skew(), reason="fleet",
                            step=self.tick_count, capture=raw, pred=pred)
                        job.view.register(job.controller.current_conns())
            with tr.span("waterfill", delta=True):
                try:
                    achieved = self.achieved()
                except WaterfillDivergence as exc:
                    raise WaterfillDivergence(
                        f"{exc} (fleet tick {self.tick_count})") from exc
            for job in self.jobs.values():
                P = job.controller.n_pods
                off = ~np.eye(P, dtype=bool)
                bw = achieved[job.name]
                env = envs[job.name]
                cap_off = env.link_cap[off]
                rows.append({
                    "name": job.name,
                    "priority": job.priority,
                    "budget": int(env.max_conns),
                    "cap_min": float(cap_off.min()),
                    "plan_sig": job.controller.plan.signature(),
                    "achieved_min": float(bw[off].min()),
                    "achieved_mean": float(bw[off].mean()),
                    "conns_total": int(job.controller.current_conns()[off]
                                       .sum()),
                })
            return {"tick": self.tick_count, "n_jobs": len(self.jobs),
                    "kernel_calls": self.predictor.kernel_calls,
                    "jobs": rows}

    def fused(self):
        """The fused one-program tick is not yet ported."""
        raise NotImplementedError("the fused fleet tick is not yet ported")

    def run_fused(self, steps: int, events: Tuple = ()
                  ) -> List[Dict[str, Any]]:
        """The fused one-program tick is not yet ported."""
        raise NotImplementedError("the fused fleet tick is not yet ported")

    def achieved(self) -> Dict[str, np.ndarray]:
        """Credited achieved BW per job at slice scale: ONE fleet-wide
        water-fill over every registered tenant, then each job's
        envelope cap applied as TC shaping (§3.2.2)."""
        regs = {name: self.sim.tenant_conns[name]
                for name in self.jobs if name in self.sim.tenant_conns}
        per_tenant = self.sim.waterfill_tenants(regs)
        out = {}
        for job in self.jobs.values():
            bw = job.view.extract(per_tenant[job.name])
            env = job.controller.envelope
            if env is not None and env.link_cap is not None:
                off = ~np.eye(job.view.N, dtype=bool)
                bw = np.where(off, np.minimum(bw, env.link_cap), bw)
            out[job.name] = bw
        return out
