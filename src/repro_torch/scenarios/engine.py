"""Scenario engine: drives the full closed loop (simulator -> monitor
-> predictor -> global opt -> AIMD -> plan) through a scripted timeline
of WAN events and records a structured per-step trace.

Each step:

  1. apply the events scheduled ``at(step)`` (events.py);
  2. advance scripted processes (diurnal modulation, skew ramp) and the
     simulator's AR(1) fluctuation — the engine owns simulated time, so
     the controller runs with ``advance_sim=False``;
  3. measure the ground-truth achieved BW at the connection matrix in
     force and derive a synthetic step time (compute + ring transfer at
     the slowest pod hop), times any injected straggler slowdown;
  4. feed the step time to the straggler trigger and poll the periodic
     trigger (with the current skew weights);
  5. lower the plan through the controller's compile cache — a replan
     that oscillates back to a seen signature is a cache hit, not a
     rebuild;
  6. append a :class:`StepTrace` row (monitored vs predicted vs
     achieved BW, replans with reasons, plan signature, cache state).

Determinism: with the simulator's named RNG streams, the same spec and
seed replay to byte-identical traces (``ScenarioTrace.to_json()``).

Port of `repro/scenarios/engine.py`. The loop is host numpy float64
as in the JAX package, so with the default `SnapshotPredictor` and
the numpy water-fill the traces are the reference's bytes (the 12
`scenario/*` pins); with a `BwPredictor` on the card each replan's
forest runs as one `rf_predict` launch, and with
``WanSimulator(waterfill_backend="cuda")`` each fill as one
`waterfill` launch. Spans (``obs="on"``) are passive. Not yet ported,
and raising `NotImplementedError` at construction: the overlay
(``overlay="on"``), the predictor lifecycle (``lifecycle`` resolving
to ``on``, or a manager object), and the fault plane (``faults``
resolving to ``on``, a plane object, or any fault event in the
timeline, for which the reference builds an ungraceful plane).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control import ControllerConfig, WanifyController
from repro_torch.core.predictor import SnapshotPredictor
from repro_torch.faults.plane import faults_mode
from repro_torch.lifecycle.manager import lifecycle_mode
from repro_torch.obs.spans import NULL_TRACER, SpanTracer, obs_mode
from repro_torch.scenarios.events import Timed
from repro_torch.scenarios.trace import (ScenarioResult, ScenarioTrace,
                                         StepTrace, sig_hash)
from repro_torch.wan.simulator import WanSimulator, WaterfillDivergence


@dataclass
class ScenarioSpec:
    """A named, replayable stress scenario for the control plane."""
    name: str
    steps: int
    events: Tuple[Timed, ...] = ()
    description: str = ""
    n_pods: int = 4
    regions: Optional[List[str]] = None      # default: the 8-DC testbed
    sim_kwargs: Dict[str, Any] = field(default_factory=dict)
    cfg_kwargs: Dict[str, Any] = field(default_factory=dict)
    payload_mb: float = 256.0                # per-step ring payload
    compute_s: float = 0.5                   # non-network step time


class ScenarioEngine:
    """One deterministic run of a :class:`ScenarioSpec`."""

    def __init__(self, spec: ScenarioSpec, seed: int = 0,
                 predictor: Any = None, overlay: Optional[str] = None,
                 lifecycle: Any = None, obs: Optional[str] = None,
                 faults: Any = None):
        self.spec = spec
        self.seed = int(seed)
        sim_kw = dict(spec.sim_kwargs)
        if spec.regions is not None:
            sim_kw.setdefault("regions", list(spec.regions))
        self.sim = WanSimulator(seed=self.seed, **sim_kw)
        cfg_kw = dict(spec.cfg_kwargs)
        cfg_kw.pop("advance_sim", None)    # the engine owns simulated time
        cfg = ControllerConfig(advance_sim=False, **cfg_kw)
        pred_obj = predictor or SnapshotPredictor()
        # `lifecycle` gates the online predictor lifecycle: a manager
        # object, or a mode resolving (via $REPRO_LIFECYCLE) to "on",
        # is not yet ported; off means no manager and no lifecycle code
        if (lifecycle is not None and not isinstance(lifecycle, str)) \
                or lifecycle_mode(lifecycle) == "on":
            raise NotImplementedError(
                "the predictor lifecycle is not yet ported")
        self.lifecycle = None
        # `faults` gates the fault plane: a plane object, a mode
        # resolving (via $REPRO_FAULTS) to "on", or a timeline that
        # scripts fault events (the reference's ungraceful plane) is
        # not yet ported; off with no fault events means no plane.
        # FaultEvent is imported lazily: faults.events subclasses the
        # event DSL of this package, so a module-level import would be
        # circular through repro_torch.scenarios.__init__
        from repro_torch.faults.events import FaultEvent
        if (faults is not None and not isinstance(faults, str)) \
                or faults_mode(faults) == "on" \
                or any(isinstance(t.event, FaultEvent)
                       for t in spec.events):
            raise NotImplementedError("the fault plane is not yet ported")
        self.faults = None
        # `overlay` gates Terra-style relay routing (None defers to
        # $REPRO_OVERLAY, default off); the controller raises for "on"
        self.controller = WanifyController(
            sim=self.sim, predictor=pred_obj,
            n_pods=spec.n_pods, cfg=cfg, overlay=overlay)
        # `obs` gates span tracing (repro_torch.obs; None defers to
        # $REPRO_OBS, default off = the shared no-op tracer). Spans are
        # PASSIVE: they wrap the stages the loop already runs, in the
        # order it already runs them, so traces replay byte-identical
        # either way.
        self.tracer = NULL_TRACER
        if obs_mode(obs) == "on":
            self.tracer = SpanTracer()
            self.tracer.watch(self.sim.metrics)
            self.tracer.watch(self.controller.metrics)
            self.controller.tracer = self.tracer
        self.step = 0
        # a per-step tap for ride-along harnesses (placement, later):
        # called as step_hook(engine, step_trace_row) after each step's
        # trace row is appended; it must not mutate sim/controller state
        self.step_hook: Optional[Any] = None
        # scripted-process state (mutated by events)
        self.diurnal: Optional[Tuple[float, int, int]] = None
        self.straggler_mult = 1.0
        self.straggler_until = -1
        self._skew: Optional[np.ndarray] = None          # current weights
        self._skew_ramp: Optional[Tuple[np.ndarray, np.ndarray, int, int]] \
            = None                                       # (from, to, at, over)
        self._timeline: Dict[int, List[Timed]] = {}
        for t in spec.events:
            self._timeline.setdefault(t.step, []).append(t)

    # ------------------------------------------------------------------
    # Helpers the events call back into
    # ------------------------------------------------------------------
    def link(self, pair: Sequence[str]) -> Tuple[int, int]:
        """Resolve a (region, region) pair to simulator indices."""
        a, b = pair
        return self.sim.regions.index(a), self.sim.regions.index(b)

    def dc(self, region: str) -> int:
        """Resolve one region name to its simulator index (fault
        events target single DCs, not link pairs)."""
        return self.sim.regions.index(region)

    def start_skew_ramp(self, weights: Sequence[float], over: int) -> None:
        """Begin ramping the skew weights to `weights` over `over`
        steps (SkewRamp event target)."""
        # refit any previous skew to the new vector's length (neutral
        # weight for pods it did not cover) so ramps compose with
        # rescales of either direction
        start = np.ones(len(weights))
        if self._skew is not None:
            k = min(len(start), len(self._skew))
            start[:k] = self._skew[:k]
        self._skew_ramp = (start, np.asarray(weights, float), self.step,
                           max(1, int(over)))

    def skew_for_pods(self, n_pods: Optional[int] = None
                      ) -> Optional[np.ndarray]:
        """Current skew weights fitted to `n_pods` (default: the
        controller's current count; a Rescale event passes its target
        count). Pods that joined after the ramp started carry neutral
        weight."""
        if self._skew is None:
            return None
        P = self.controller.n_pods if n_pods is None else int(n_pods)
        w = np.ones(P)
        k = min(P, len(self._skew))
        w[:k] = self._skew[:k]
        return w

    # ------------------------------------------------------------------
    # The synthetic workload: one ring exchange per step
    # ------------------------------------------------------------------
    def _full_conns(self) -> np.ndarray:
        return self.controller.current_conns()

    def _ring_min_bw(self, achieved: np.ndarray) -> float:
        P = self.controller.n_pods
        if P < 2:
            return float("inf")
        return min(float(achieved[i, (i + 1) % P]) for i in range(P))

    def _step_time(self, achieved: np.ndarray) -> float:
        ring = max(self._ring_min_bw(achieved), 1e-6)
        dt = self.spec.compute_s + self.spec.payload_mb * 8.0 / ring
        if self.step < self.straggler_until:
            dt *= self.straggler_mult
        return dt

    # ------------------------------------------------------------------
    def _advance_scripted(self) -> None:
        if self.diurnal is not None:
            amp, period, start = self.diurnal
            phase = 2.0 * math.pi * (self.step - start) / max(period, 1)
            self.sim.modulation = 1.0 + amp * math.sin(phase)
        if self._skew_ramp is not None:
            w0, w1, at_step, over = self._skew_ramp
            frac = min(1.0, (self.step - at_step) / over)
            self._skew = w0 + (w1 - w0) * frac
            if frac >= 1.0:
                self._skew_ramp = None

    def _recover_divergence(self, k: int,
                            exc: WaterfillDivergence) -> None:
        """Water-fill divergence at step `k`: without a graceful fault
        plane (the only case while the plane is unported) the
        divergence propagates with scenario/step context attached."""
        raise WaterfillDivergence(
            f"{exc} (scenario {self.spec.name!r}, step {k})") from exc

    def run(self) -> ScenarioResult:
        """Drive the timeline to completion and return the trace."""
        ctl, sim, tr = self.controller, self.sim, self.tracer
        trace = ScenarioTrace(self.spec.name, self.seed)
        seen_records = len(ctl.record)
        # lower the initial plan once (the consumer's first compile)
        ctl.compiled((self.spec.name,), lambda p: p.signature())
        for k in range(self.spec.steps):
            self.step = k
            with tr.span("events"):
                applied = tuple(t.event.describe()
                                for t in self._timeline.get(k, ()))
                for t in self._timeline.get(k, ()):
                    t.event.apply(self)
                self._advance_scripted()
                sim.advance()

            with tr.span("waterfill", delta=True):
                conns = self._full_conns()
                try:
                    achieved = sim.waterfill(conns)
                except WaterfillDivergence as exc:
                    self._recover_divergence(k, exc)
            with tr.span("control", delta=True):
                dt = self._step_time(achieved)
                ctl.observe_step_time(dt, step=k)
                ctl.maybe_replan(k, skew_w=self.skew_for_pods())
            # every plan in force goes through the compile cache: a
            # signature seen before is a hit, not a rebuild
            with tr.span("lower", delta=True):
                ctl.compiled((self.spec.name,), lambda p: p.signature())

            # sampled at the same matrix as `achieved`, so in a quiet
            # scenario monitored == achieved exactly, replan step or not
            with tr.span("measure"):
                monitored = ctl.monitor.measure(conns)
            P = ctl.n_pods
            off = ~np.eye(P, dtype=bool)
            pred = ctl.last_pred[:P, :P]
            replans = tuple(
                {"reason": r["reason"], "step": r["step"],
                 "signature": sig_hash(r["signature"])}
                for r in ctl.record[seen_records:])
            seen_records = len(ctl.record)
            plan = ctl.plan
            trace.steps.append(StepTrace(
                step=k, events=applied, dt=float(dt),
                achieved_min=float(achieved[:P, :P][off].min()),
                achieved_mean=float(achieved[:P, :P][off].mean()),
                monitored_min=float(monitored[:P, :P][off].min()),
                monitored_mean=float(monitored[:P, :P][off].mean()),
                predicted_min=float(pred[off].min()),
                predicted_mean=float(pred[off].mean()),
                plan_sig=sig_hash(plan.signature()),
                n_pods=P,
                conns_total=int(sum(plan.conns[i][j]
                                    for i in range(P) for j in range(P)
                                    if i != j)),
                replans=replans,
                cache_builds=ctl.cache_builds,
                cache_hits=ctl.cache_hits,
            ))
            if self.step_hook is not None:
                self.step_hook(self, trace.steps[-1])
        return ScenarioResult(trace=trace, payload_mb=self.spec.payload_mb)


def run_scenario(spec: ScenarioSpec, seed: int = 0,
                 predictor: Any = None,
                 overlay: Optional[str] = None,
                 lifecycle: Any = None,
                 obs: Optional[str] = None,
                 faults: Any = None) -> ScenarioResult:
    """Build a fresh engine and run the scenario to completion
    (`overlay` gates relay routing, `lifecycle` the predictor
    lifecycle, `obs` span tracing, `faults` the fault plane; None
    defers to $REPRO_OVERLAY / $REPRO_LIFECYCLE / $REPRO_OBS /
    $REPRO_FAULTS)."""
    return ScenarioEngine(spec, seed=seed, predictor=predictor,
                          overlay=overlay, lifecycle=lifecycle,
                          obs=obs, faults=faults).run()
