"""WanifyController — the paper's closed loop as a first-class subsystem.

The loop (cheap snapshot -> RF runtime-BW prediction -> global
connection-range optimization -> per-DC AIMD adaptation -> transfer
plan) used to live as private machinery inside the training loop; this
controller owns it once, shared by training, serving, and planning:

  * monitoring   — a :class:`SnapshotMonitor` captured at the CURRENT
    connection matrix (the seed measured at all-ones, so the agents
    adapted against traffic-free links);
  * prediction   — any object with ``predict_matrix`` (the RF
    :class:`BwPredictor`, or :class:`SnapshotPredictor` for the paper's
    no-prediction ablation);
  * optimization — :func:`global_optimize` ranges + per-DC AIMD agents
    fine-tuning inside them;
  * plan cache   — :meth:`compiled` memoizes consumer-built artifacts
    (lowered steps, migrations) on ``WanPlan.signature()`` so
    oscillating plans never rebuild; `cache_builds`/`cache_hits`
    count lowerings vs reuses;
  * triggers     — periodic (:meth:`maybe_replan`), straggler
    (:meth:`observe_step_time`), explicit topology change
    (:meth:`topology_changed`), elastic rescale (:meth:`rescale`,
    paper §3.3.2) and on-demand (:meth:`replan`, e.g. serve-side);
  * event log    — human-readable `events` (shareable with a consumer's
    own log) plus a structured `record` of every replan, mirrored to an
    optional `trace_hook` callable (the scenario engine's tap); the
    last predicted matrix is kept on `last_pred` so a harness can line
    up predicted vs achieved BW per step.

Port of `repro/control/controller.py`. The loop is host numpy, as in
the JAX package, so replans are bit-identical, the overlay's routed
plan (``overlay="on"``), the lifecycle's prediction clamp and an
attached fault plane's capture and prediction hooks included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.global_opt import global_optimize
from repro_torch.core.local_opt import AimdAgent
from repro_torch.core.plan import WanPlan
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.spans import NULL_TRACER
from repro_torch.overlay.routing import RoutedPlan, overlay_mode, plan_routes
from repro_torch.wan.monitor import SnapshotMonitor
from repro_torch.wan.simulator import WanSimulator


@dataclass(frozen=True)
class BudgetEnvelope:
    """Externally arbitrated resource envelope for one job (tenant).

    A fleet controller (repro_torch.fleet) computes one of these per job
    before each arbitration epoch: `max_conns` replaces the job's own
    per-host budget M for its next `global_optimize`, and `link_cap`
    ([P,P] Mbps at the job's pod scale, np.inf = uncapped) joins the
    §3.2.2 throttle so the job never targets more than its weighted
    fair share of a contended link. A job without an envelope plans
    exactly as before — the envelope is opt-in, not a new code path.
    """
    max_conns: int
    link_cap: Optional[np.ndarray] = None


@dataclass
class ControllerConfig:
    """Tuning knobs of one controller's triggers and budget."""

    max_conns: int = 8               # M, per-host connection budget
    replan_every: int = 20           # periodic trigger cadence (steps)
    straggler_factor: float = 2.5    # step slower than factor x EWMA
    straggler_cooldown: int = 0      # min steps between straggler replans
    #                                  (0 = trigger on every slow step)
    ewma_alpha: float = 0.1          # step-time EWMA smoothing
    advance_sim: bool = True         # advance link fluctuation on the
    #                                  periodic trigger (simulated time)

    def __post_init__(self) -> None:
        """Fail loudly at construction — a bad knob here otherwise
        misbehaves ticks later (replan_every=0 divides by zero, a
        non-positive straggler factor replans every single step)."""
        if self.max_conns < 1:
            raise ValueError(f"max_conns must be >= 1, got "
                             f"{self.max_conns}")
        if self.replan_every < 1:
            raise ValueError(f"replan_every must be >= 1, got "
                             f"{self.replan_every}")
        if self.straggler_factor <= 0:
            raise ValueError(f"straggler_factor must be > 0, got "
                             f"{self.straggler_factor}")
        if self.straggler_cooldown < 0:
            raise ValueError(f"straggler_cooldown must be >= 0, got "
                             f"{self.straggler_cooldown}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")


class WanifyController:
    """One instance per workload (a Trainer, a serving Engine, a
    planner); `n_pods` may be smaller than the monitored cluster."""

    def __init__(self, sim: WanSimulator, predictor: Any, n_pods: int,
                 cfg: Optional[ControllerConfig] = None,
                 events: Optional[List[str]] = None,
                 trace_hook: Optional[Callable[[Dict[str, Any]], None]]
                 = None,
                 envelope: Optional[BudgetEnvelope] = None,
                 overlay: Optional[str] = None,
                 lifecycle: Optional[Any] = None):
        self.sim = sim
        self.predictor = predictor
        self.n_pods = int(n_pods)
        self.cfg = cfg or ControllerConfig()
        # Terra-style overlay routing gate: "on" runs the relay search
        # on every replan and exposes the result on `routed` /
        # `current_routing()`; "off" (default, or $REPRO_OVERLAY) runs
        # no routed code path at all, keeping replays byte-identical
        self.overlay = overlay_mode(overlay)
        self.routed: Optional[RoutedPlan] = None
        # online predictor lifecycle (repro_torch.lifecycle): when a
        # manager is attached, every replan's predicted matrix passes
        # through its capacity clamp; None (default) runs no lifecycle
        # code
        self.lifecycle = lifecycle
        self.monitor = SnapshotMonitor(sim)
        # a consumer may hand in its own log list; both append to it
        self.events: List[str] = events if events is not None else []
        self.record: List[Dict[str, Any]] = []
        self.trace_hook = trace_hook
        self.plan_cache: Dict[Tuple, Any] = {}
        # ad-hoc counters live on the obs registry (repro_torch.obs);
        # `cache_builds`/`cache_hits` stay readable as properties
        self.metrics = MetricsRegistry("controller")
        self._m_builds = self.metrics.counter(
            "cache_builds", help="plan-cache misses (artifacts lowered)")
        self._m_hits = self.metrics.counter(
            "cache_hits", help="plan-cache reuses")
        self._m_replans = self.metrics.counter(
            "replans_total", help="full loop iterations run")
        # span tracer: NULL_TRACER unless a harness installs a real one
        # (scenario engine / fleet controller with REPRO_OBS=on)
        self.tracer = NULL_TRACER
        self.last_pred: Optional[np.ndarray] = None
        self.envelope = envelope     # arbitrated budget (None = own M)
        # fault plane (repro_torch.faults): when an engine attaches one,
        # replan captures/predictions route through its degradation
        # ladder; None (default) runs no fault code at all
        self.faults: Optional[Any] = None
        self._prev_plan: Optional[WanPlan] = None
        self._agents: Optional[List[AimdAgent]] = None
        self._ewma: Optional[float] = None
        self._last_straggler: Optional[int] = None
        self._obs_count = 0
        self.plan = self.replan(reason="init")

    # ------------------------------------------------------------------
    # The closed loop
    # ------------------------------------------------------------------
    def current_conns(self) -> np.ndarray:
        """Connection matrix currently in force, at monitor scale
        (idle/unmanaged links run a single connection)."""
        c = np.ones((self.sim.N, self.sim.N))
        if self._agents is not None:
            for i, ag in enumerate(self._agents):
                c[i, :self.n_pods] = ag.cons
        return c

    def set_envelope(self, envelope: Optional[BudgetEnvelope]) -> None:
        """Adopt (or clear) an arbitrated budget/throttle envelope; it
        takes effect at the next replan."""
        self.envelope = envelope

    def add_trace_hook(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Compose `fn` onto the replan trace stream, keeping any hook
        already installed — the scenario engine's tap and a placement
        planner's re-place trigger can both listen to one controller."""
        prev = self.trace_hook
        if prev is None:
            self.trace_hook = fn
        else:
            def both(rec, _prev=prev, _fn=fn):
                _prev(rec)
                _fn(rec)
            self.trace_hook = both

    def replan(self, skew_w: Optional[np.ndarray] = None,
               reason: str = "explicit",
               step: Optional[int] = None, *,
               capture: Optional[Dict[str, np.ndarray]] = None,
               pred: Optional[np.ndarray] = None) -> WanPlan:
        """Run one full loop iteration and return the resulting plan.

        `capture` / `pred` let an outer orchestrator supply the raw
        snapshot and the predicted-BW matrix instead of this controller
        capturing/predicting itself — the fleet controller captures
        every job first, stacks the feature rows, runs ONE batched RF
        kernel launch, then hands each job its slice here. Both must be
        at monitor scale ([N,N] of `self.sim`); AIMD feedback still
        comes from the capture's snapshot.
        """
        tr = self.tracer
        conns = self.current_conns()
        # the matrix the snapshot was measured at: consumers scaling
        # predicted BW to a different connection count (the placement
        # planner's achievable-BW pricing) scale from this operating
        # point via the paper's BW-grows-linearly-with-conns claim
        self.last_capture_conns = conns
        pred_override = None
        if capture is None:
            with tr.span("snapshot"):
                if self.faults is not None:
                    # the fault boundary: injected probe faults /
                    # monitor outages surface here; graceful mode
                    # climbs the retry/staleness ladder and may hand
                    # back a prediction override (the SnapshotPredictor
                    # rung) when the capture is too stale to trust
                    capture, pred_override = self.faults.captured(
                        self.monitor, conns)
                else:
                    _, capture = self.monitor.capture(conns)
        raw = capture
        if pred is None:
            if pred_override is not None:
                pred = pred_override
            else:
                with tr.span("predict"):
                    pred = self.predictor.predict_matrix(
                        self.sim.N, raw["snapshot_bw"], raw["mem_util"],
                        raw["cpu_load"], raw["retrans"], raw["dist"])
            if self.faults is not None:
                # inject any scripted predictor fault, then (graceful)
                # quarantine poisoned rows before they reach the solver
                pred = self.faults.predicted(pred, raw["snapshot_bw"])
        if self.lifecycle is not None:
            # sanity clamp: the RF may not promise BW beyond what the
            # lifecycle's windowed percentile capacity has ever seen
            pred = self.lifecycle.adjust_prediction(pred)
        pods = pred[:self.n_pods, :self.n_pods]
        M = self.cfg.max_conns
        link_cap = None
        if self.envelope is not None:
            M = int(self.envelope.max_conns)
            if self.envelope.link_cap is not None:
                link_cap = np.asarray(self.envelope.link_cap, np.float64)
                if link_cap.shape != (self.n_pods, self.n_pods):
                    # a mesh-scale cap silently prefix-sliced would cap
                    # the WRONG links for any non-prefix DC slice
                    raise ValueError(
                        f"envelope link_cap shape {link_cap.shape} != "
                        f"({self.n_pods}, {self.n_pods}); slice caps to "
                        f"the controller's pod scale first (the fleet "
                        f"does this via TenantView.extract)")
        with tr.span("optimize"):
            gp = global_optimize(pods, M=M, w_s=skew_w, link_cap=link_cap)
        with tr.span("aimd"):
            if self._agents is None or len(self._agents) != self.n_pods:
                self._agents = [AimdAgent.from_plan(gp, i)
                                for i in range(self.n_pods)]
            else:
                # fine-tune inside the new global bounds against BW
                # monitored at the connection matrix actually in force —
                # the capture above already measured at `conns`, so
                # reuse it instead of paying a second waterfill + noise
                # draw
                monitored = raw["snapshot_bw"][:self.n_pods, :self.n_pods]
                for i, ag in enumerate(self._agents):
                    ag.min_cons, ag.max_cons = gp.min_cons[i], gp.max_cons[i]
                    ag.min_bw, ag.max_bw = gp.min_bw[i], gp.max_bw[i]
                    ag.unit_bw, ag.throttle = gp.pred_bw[i], gp.throttle[i]
                    ag.step(monitored[i])
            cons = np.stack([ag.cons for ag in self._agents])
        plan = WanPlan(
            n_pods=self.n_pods,
            conns=tuple(tuple(int(v) for v in row) for row in cons),
            pred_bw=tuple(tuple(float(v) for v in row)
                          for row in gp.pred_bw),
            compress_bits=WanPlan.from_global(gp).compress_bits,
        )
        self._prev_plan = getattr(self, "plan", None)
        self.plan = plan
        self.last_pred = pred
        off = ~np.eye(self.n_pods, dtype=bool)
        rec = {"reason": reason, "step": step,
               "signature": plan.signature(), "n_pods": self.n_pods,
               "pred_min": float(pods[off].min()) if off.any() else 0.0,
               "pred_mean": float(pods[off].mean()) if off.any() else 0.0}
        if self.overlay == "on":
            # route selection rides every replan: split each pair's
            # planned connections between the direct link and the best
            # closeness-pruned one-hop relay on the predicted surface
            with tr.span("route"):
                self.routed = plan_routes(
                    gp.pred_bw, cons, dc_rel=gp.dc_rel,
                    capture_conns=self.last_capture_conns)
            rec["overlay"] = "on"
            rec["relays"] = self.routed.relays
            rec["routed_signature"] = self.routed.signature()
        self._m_replans.inc()
        self.metrics.counter("replans", labels={"reason": reason}).inc()
        self.record.append(rec)
        if self.trace_hook is not None:
            self.trace_hook(rec)
        return plan

    def current_routing(self) -> Optional[Tuple[np.ndarray, Tuple]]:
        """The in-force overlay routing lowered to monitor scale, or
        None when the overlay is off (or chose no relays): a
        ``(direct, relays)`` pair for
        :meth:`WanSimulator.waterfill_routed` — the [N,N] direct
        connection matrix (relay shares already moved off the weak
        pairs) plus the chosen ``(src, via, dst, conns)`` paths."""
        if self.routed is None or not self.routed.relays:
            return None
        direct = self.current_conns()
        P = self.n_pods
        direct[:P, :P] = np.asarray(self.routed.direct, np.float64)
        return direct, self.routed.relays

    def rollback_plan(self, step: Optional[int] = None
                      ) -> Optional[WanPlan]:
        """Restore the last-known-good plan (fault-plane rung 5).

        Called by an engine when executing the CURRENT plan failed
        downstream (a diverging water-fill): re-adopt the previous
        plan and reseat every AIMD agent's connection vector on it, so
        the next step runs a configuration that is known to have
        executed. The restored plan's signature is already in the plan
        cache, so the consumer's re-lower is a cache hit, not a
        rebuild. Returns the restored plan, or None when there is no
        previous plan to roll back to (the bad plan stays in force)."""
        prev = self._prev_plan
        if prev is None:
            return None
        self.plan = prev
        self._prev_plan = None       # don't ping-pong between two plans
        if self._agents is not None and len(prev.conns) == self.n_pods:
            for i, ag in enumerate(self._agents):
                ag.cons = np.array(prev.conns[i], np.int64)
        self.events.append(f"rolled back to last-known-good plan at "
                           f"step {step}")
        rec = {"reason": "rollback", "step": step,
               "signature": prev.signature(), "n_pods": self.n_pods,
               "pred_min": 0.0, "pred_mean": 0.0}
        self.record.append(rec)
        if self.trace_hook is not None:
            self.trace_hook(rec)
        return prev

    # ------------------------------------------------------------------
    # Triggers
    # ------------------------------------------------------------------
    def replan_due(self, step: int) -> bool:
        """True when the periodic trigger fires at this step."""
        return (step + 1) % self.cfg.replan_every == 0

    def maybe_replan(self, step: int,
                     skew_w: Optional[np.ndarray] = None
                     ) -> Optional[WanPlan]:
        """Periodic trigger: returns the new plan iff it is due AND its
        signature differs (a signature-stable replan needs no re-lower,
        so the consumer can keep its compiled step)."""
        if not self.replan_due(step):
            return None
        if self.cfg.advance_sim:
            self.sim.advance()
        old_sig = self.plan.signature()
        new = self.replan(skew_w=skew_w, reason="periodic", step=step)
        if new.signature() == old_sig:
            return None
        self.events.append(f"replanned at step {step}")
        return new

    def observe_step_time(self, dt: float,
                          step: Optional[int] = None
                          ) -> Optional[WanPlan]:
        """Straggler trigger: feed per-step wall time; a step slower
        than `straggler_factor` x EWMA forces an AIMD multiplicative
        decrease on every agent plus an immediate replan."""
        eff_step = self._obs_count if step is None else step
        self._obs_count += 1
        if self._ewma is None:
            self._ewma = dt
        plan = None
        in_cooldown = (self._last_straggler is not None and
                       eff_step - self._last_straggler
                       < self.cfg.straggler_cooldown)
        if dt > self.cfg.straggler_factor * self._ewma and not in_cooldown:
            self.events.append(f"straggler at step {eff_step} ({dt:.2f}s)")
            self._last_straggler = eff_step
            for ag in self._agents or []:
                ag.step(np.zeros_like(ag.target_bw))
            plan = self.replan(reason="straggler", step=eff_step)
        self._ewma = (1 - self.cfg.ewma_alpha) * self._ewma \
            + self.cfg.ewma_alpha * dt
        return plan

    def topology_changed(self) -> WanPlan:
        """Explicit trigger: the cluster changed under us (links added /
        removed, provider migration). Discard adapted state — the old
        AIMD bounds no longer describe the network."""
        self._agents = None
        self._ewma = None
        self._last_straggler = None
        self.events.append("topology changed; replanning from scratch")
        return self.replan(reason="topology")

    def rescale(self, n_pods: int,
                skew_w: Optional[np.ndarray] = None) -> WanPlan:
        """Elastic rescale (§3.3.2): plan for a new pod count. The
        predictor covers the new cluster size (n_dcs is a Table-3
        feature); agents restart from the new global ranges."""
        if n_pods > self.sim.N:
            raise ValueError(
                f"n_pods={n_pods} exceeds monitored cluster ({self.sim.N})")
        self.n_pods = int(n_pods)
        self._agents = None
        self._ewma = None        # step times change scale with pod count
        self._last_straggler = None
        self.events.append(f"rescaled controller to {n_pods} pods")
        return self.replan(skew_w=skew_w, reason=f"rescale:{n_pods}")

    # ------------------------------------------------------------------
    # Plan cache
    # ------------------------------------------------------------------
    def compiled(self, extra_key: Tuple, build: Callable[[WanPlan], Any]):
        """Memoize `build(plan)` on (plan.signature(), *extra_key):
        re-plans that oscillate back to a seen signature reuse the
        compiled artifact instead of re-lowering."""
        key = (self.plan.signature(),) + tuple(extra_key)
        if key not in self.plan_cache:
            self._m_builds.inc()
            self.plan_cache[key] = build(self.plan)
        else:
            self._m_hits.inc()
        return self.plan_cache[key]

    @property
    def cache_builds(self) -> int:
        """Plan-cache misses (artifacts lowered); registry-backed."""
        return int(self._m_builds.value)

    @cache_builds.setter
    def cache_builds(self, v: int) -> None:
        """Reset path (tests zero the tally between phases)."""
        self._m_builds.reset(int(v))

    @property
    def cache_hits(self) -> int:
        """Plan-cache reuses; registry-backed."""
        return int(self._m_hits.value)

    @cache_hits.setter
    def cache_hits(self, v: int) -> None:
        """Reset path for the reuse tally."""
        self._m_hits.reset(int(v))
