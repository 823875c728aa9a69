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
* attached placement planners (:meth:`FleetController.job_planner`)
  run DEFERRED: the tick flushes every job's pending re-placement
  through one `placement.optimizer.search_many` lock-step pass, fusing
  same-shape search rounds across jobs into shared batched-evaluator
  calls instead of J independent Python searches.

A fleet tick is one arbitration epoch (the paper's 5-second local-
optimizer cadence, fleet-wide): all active jobs replan together so the
batched kernel launch and the single water-fill amortize across jobs —
per-tick cost grows sublinearly in job count (benchmarks/fleet_bench).

Job arrival bootstraps its controller's init plan from the snapshot-
as-prediction ablation (no RF launch), under an envelope arbitrated at
arrival — the one-launch-per-tick invariant holds through churn.

Port of `repro/fleet/controller.py`: the same host numpy control
plane around the CUDA forest kernel, so tick records equal the JAX
package's; `fused`/`run_fused` run the whole tick as tensor programs
on the predictor's device (`fleet/fused.py`). A graceful fault plane
quarantines dead DCs in arbitration, sanitizes each job's prediction
and rolls every job back on a water-fill divergence, as the
reference's does; the fused tick takes no plane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.control import ControllerConfig, WanifyController
from repro_torch.core.predictor import SnapshotPredictor, matrix_from_pairs
from repro_torch.faults.plane import FaultPlane, faults_mode
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
        `faults` gates the fault plane (repro_torch.faults; a FaultPlane
        is used as-is, else the mode resolves via $REPRO_FAULTS): when
        graceful, blacked-out DCs are quarantined in arbitration,
        poisoned predictions sanitized, and water-fill divergence
        recovered by rolling every job back to its last-good plan."""
        self.sim = sim
        self.predictor = predictor
        self.m_total = int(m_total)
        self.jobs: Dict[str, FleetJob] = {}
        self.tick_count = 0
        self.events: List[str] = []
        self._planners: List[Tuple[str, Any]] = []
        self.tracer = NULL_TRACER
        if obs_mode(obs) == "on":
            self.tracer = SpanTracer()
            self.tracer.watch(self.sim.metrics)
            self.tracer.watch(self.predictor.metrics)
        self.faults: Optional[FaultPlane] = None
        if isinstance(faults, FaultPlane):
            self.faults = faults
        elif faults_mode(faults) == "on":
            self.faults = FaultPlane(self.sim.N, graceful=True)
        if self.faults is not None and self.tracer.enabled:
            self.tracer.watch(self.faults.metrics)
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
        self._planners = [(n, p) for n, p in self._planners if n != name]
        self.events.append(f"job {name} departed")

    def set_priority(self, name: str, priority: float) -> None:
        """Shift a job's weight; takes effect at the next arbitration."""
        self.jobs[name].priority = float(priority)
        self.events.append(f"job {name} priority -> {priority}")

    def job_planner(self, name: str, query, **kwargs):
        """Attach a :class:`repro_torch.placement.PlacementPlanner` to
        one admitted job: the planner prices the query against the
        job's arbitrated :class:`BudgetEnvelope` (its `link_cap` clamps
        the achievable BW), and re-places on every fleet-tick replan. A
        low-priority tenant therefore plans around its fair share of a
        contended link, not the raw capacity.

        Fleet planners run DEFERRED: a tick's replans only mark each
        planner pending, and :meth:`tick` flushes all J pending
        searches through one `placement.optimizer.search_many`
        lock-step pass — same-shape rounds across jobs fuse into
        single batched-evaluator calls instead of J independent
        Python searches."""
        from repro_torch.placement.planner import PlacementPlanner
        planner = PlacementPlanner(self.jobs[name].controller, query,
                                   **kwargs)
        planner.defer_replans()
        self._planners.append((name, planner))
        return planner

    def _flush_planners(self) -> None:
        """Run every pending deferred placement search in one fused
        `search_many` pass and commit the results (detached planners —
        the documented replacement flow — are pruned here, so a job
        that rotates planners doesn't accumulate dead entries)."""
        from repro_torch.placement.optimizer import search_many
        self._planners = [(n, p) for n, p in self._planners
                          if not p._detached]
        owners, tasks = [], []
        for _, planner in self._planners:
            task = planner.pending_task()
            if task is not None:
                owners.append(planner)
                tasks.append(task)
        if not tasks:
            return
        for planner, decision in zip(owners, search_many(tasks)):
            planner.commit(decision)

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
        reach = None
        if self.faults is not None and self.faults.graceful:
            # DC quarantine: dead DCs stop counting toward budget
            # splits and dead pairs' caps go to zero, so survivors
            # grow into the freed share while touched jobs shrink
            reach = self.faults.reachable_mask()
        envs = arbiter.arbitrate(triples, self.sim.N, self.m_total,
                                 self.capacity_estimate(),
                                 reachable=reach)
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
                        if self.faults is not None and self.faults.graceful:
                            # quarantine poisoned rows before the job's
                            # solver sees them (raw is at slice scale —
                            # the job's monitor wraps its TenantView)
                            pred = self.faults.sanitize_matrix(
                                pred, raw["snapshot_bw"])
                        job.controller.replan(
                            skew_w=job.skew(), reason="fleet",
                            step=self.tick_count, capture=raw, pred=pred)
                        job.view.register(job.controller.current_conns())
            with tr.span("planners"):
                self._flush_planners()
            with tr.span("waterfill", delta=True):
                try:
                    if self.faults is not None \
                            and self.faults.solver_failing(self.faults.step):
                        raise WaterfillDivergence(
                            "injected water-fill divergence (SolverFault)")
                    achieved = self.achieved()
                except WaterfillDivergence as exc:
                    achieved = self._recover_divergence(exc)
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

    def _recover_divergence(self, exc: WaterfillDivergence
                            ) -> Dict[str, np.ndarray]:
        """Fleet-wide water-fill divergence: graceful mode rolls EVERY
        job back to its last-known-good plan (the registered flows a
        previous tick is known to have filled) and retries the fill
        once; without a graceful plane the divergence propagates with
        tick context attached."""
        fp = self.faults
        if fp is None or not fp.graceful:
            raise WaterfillDivergence(
                f"{exc} (fleet tick {self.tick_count})") from exc
        with self.tracer.span("recover"):
            fp.note_rollback()
            for job in self.jobs.values():
                job.controller.rollback_plan(step=self.tick_count)
                job.view.register(job.controller.current_conns())
            try:
                return self.achieved()
            except WaterfillDivergence as exc2:
                raise WaterfillDivergence(
                    f"{exc2} (fleet tick {self.tick_count}, after "
                    f"last-known-good rollback)") from exc2

    def fused(self):
        """Build the CURRENT job set into a :class:`repro_torch.fleet.
        fused.FusedFleet` — the whole tick as tensor programs on the
        predictor's device, looped over steps and batched over scenario
        grids. Requires the fused determinism contract (deterministic
        captures, fixed jobs with equal slice sizes, no deferred
        planners); see fused.py.

        Memoized on the job set / priorities / budget, so repeated
        `run_fused` calls reuse the built constants (live AIMD state is
        read fresh at each run).

        Obs spans cover the SEQUENTIAL tick only: the fused path has no
        per-stage host boundaries to time."""
        from repro_torch.fleet.fused import FusedFleet
        key = (tuple((j.name, j.spec.dcs, j.priority, j.spec.skew_w)
                     for j in self.jobs.values()),
               self.m_total, id(self.predictor.forest),
               tuple(n for n, _ in self._planners))
        cached = getattr(self, "_fused_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        ff = FusedFleet(self)
        self._fused_cache = (key, ff)
        return ff

    def run_fused(self, steps: int, events: Tuple = ()
                  ) -> List[Dict[str, Any]]:
        """Run `steps` arbitration epochs on the device and sync the
        resulting AIMD state back into the live controllers (sequential
        `tick()` calls can continue afterwards). Returns per-tick
        records (the `tick()` row body minus plan signatures)."""
        return self.fused().run(steps, events=events)

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
