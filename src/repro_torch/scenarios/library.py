"""Named scenario library — the paper's §5 settings as scripted,
replayable timelines. Each entry is a zero-argument builder so specs
are fresh (and independently mutable) per run.

The quiet scenarios (no fluctuation / observation noise) pin down
exact controller behavior — e.g. `flap` asserts the post-recovery plan
signature returns to the pre-flap one (a compile-cache hit); the noisy
ones (`diurnal`, `runtime_fluctuation`) exercise the loop under the
AR(1) dynamics of [38].

Port of `repro/scenarios/library.py`: the same 12 specs in the same
order. Two of them stage the gated planes (`cable_cut_reroute` the
overlay, `provider_shift_drift` the predictor lifecycle); with those
gates off they replay the direct-only, frozen-predictor runs the
reference pins, and with them on the runs `scenarios/goldens.py`'s
plane pins hold.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.scenarios.engine import ScenarioSpec
from repro_torch.scenarios.events import (CrossTraffic, DiurnalCycle,
                                          LinkDegrade, ProviderShift,
                                          Rescale, SkewRamp, Straggler, at,
                                          flap)

QUIET = dict(fluct_sigma=0.0, snapshot_sigma=0.0, runtime_sigma=0.0)

# Every scenario plans over the first 4 pods of the monitored 8-DC mesh
# (us-east, us-west, ap-south, ap-se): the ring hops mix near and far
# links, so plans react to both closeness classes.


def steady() -> ScenarioSpec:
    """§5.2 static baseline: no events; replans stay periodic-only."""
    return ScenarioSpec(
        name="steady", steps=40,
        description="static WAN; only init + periodic replans",
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=10))


def diurnal() -> ScenarioSpec:
    """Business-hours BW cycle ([38]): all links swing +-40%."""
    return ScenarioSpec(
        name="diurnal", steps=60,
        description="sinusoidal global BW cycle + mild AR(1) fluctuation",
        events=(at(0, DiurnalCycle(amplitude=0.4, period=30)),),
        sim_kwargs=dict(fluct_sigma=0.05, snapshot_sigma=0.02,
                        runtime_sigma=0.0),
        cfg_kwargs=dict(replan_every=5))


def runtime_fluctuation() -> ScenarioSpec:
    """Table 1's regime: pure AR(1) link fluctuation, snapshot noise."""
    return ScenarioSpec(
        name="runtime_fluctuation", steps=50,
        description="AR(1) fluctuation only; the predictor's home turf",
        sim_kwargs=dict(fluct_sigma=0.12, snapshot_sigma=0.08,
                        runtime_sigma=0.015),
        cfg_kwargs=dict(replan_every=5))


def congestion() -> ScenarioSpec:
    """Sudden cross-traffic burst on a ring hop: the step time spikes,
    the straggler trigger fires exactly once (cooldown outlasts the
    burst), AIMD backs off."""
    return ScenarioSpec(
        name="congestion", steps=30,
        description="cross-traffic burst on us-east<->us-west, steps 10-15",
        events=(at(10, CrossTraffic(("us-east", "us-west"), conns=64)),
                at(15, CrossTraffic(("us-east", "us-west"), conns=0))),
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=100, straggler_factor=2.0,
                        straggler_cooldown=30))


def link_flap() -> ScenarioSpec:
    """A link flaps (visible maintenance) and recovers: the post-
    recovery plan oscillates back to the pre-flap signature, so the
    consumer reuses the compiled step instead of re-lowering."""
    return ScenarioSpec(
        name="link_flap", steps=30,
        description="us-east<->us-west collapses 20x at step 10, "
                    "restores at step 20; plan-cache hit on recovery",
        events=tuple(flap(10, ("us-east", "us-west"), factor=0.05,
                          down_steps=10, notify=True)),
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=100))


def cable_cut() -> ScenarioSpec:
    """Silent persistent degradation (no notify): only the periodic
    trigger can discover it."""
    return ScenarioSpec(
        name="cable_cut", steps=40,
        description="ap-south<->ap-se silently collapses 50x at step 12",
        events=(at(12, LinkDegrade(("ap-south", "ap-se"), factor=0.02)),),
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=5))


def cable_cut_reroute() -> ScenarioSpec:
    """A silent cut on a FAR ring hop, staged for overlay routing:
    us-west<->ap-south collapses 50x, so its direct path is pinned at
    the knee cap (8.5x a tiny degraded single-conn BW) no matter how
    many connections AIMD pumps — while one-hop detours (us-west ->
    us-east -> ap-south, or via ap-se) keep the healthy far-class
    capacity. With ``overlay="on"`` the first post-cut replan routes
    around the cut and the pair's achieved BW recovers to the relay
    bottleneck — strictly better than direct-only
    (`tests/test_torch_overlay.py`); with the overlay off (the
    default) this replays the direct-only controller against the same
    weather."""
    return ScenarioSpec(
        name="cable_cut_reroute", steps=40,
        description="us-west<->ap-south silently collapses 50x at step "
                    "12; overlay=on relays around it via us-east/ap-se",
        events=(at(12, LinkDegrade(("us-west", "ap-south"), factor=0.02)),),
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=5))


def straggler_host() -> ScenarioSpec:
    """An injected slow host (§3.2.2): the straggler trigger forces an
    AIMD multiplicative decrease plus an immediate replan."""
    return ScenarioSpec(
        name="straggler_host", steps=30,
        description="4x step-time spike at step 15 for 2 steps",
        events=(at(15, Straggler(slowdown=4.0, duration=2)),),
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=100, straggler_factor=2.0,
                        straggler_cooldown=5))


def elastic() -> ScenarioSpec:
    """Elastic DC counts (§3.3.2 / §5.5): join two DCs, later leave."""
    return ScenarioSpec(
        name="elastic", steps=40,
        description="4 -> 6 pods at step 12, back to 4 at step 28",
        events=(at(12, Rescale(n_pods=6)), at(28, Rescale(n_pods=4))),
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=10))


def provider_shift() -> ScenarioSpec:
    """Provider heterogeneity shift (§3.3.3): half the DCs migrate to
    a provider with half the WAN capacity."""
    return ScenarioSpec(
        name="provider_shift", steps=30,
        description="DCs 0-3 shift to 0.5x provider at step 15",
        events=(at(15, ProviderShift(factors=(0.5, 0.5, 0.5, 0.5,
                                              1.0, 1.0, 1.0, 1.0))),),
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=10))


def provider_shift_drift() -> ScenarioSpec:
    """Provider shift staged for the predictor lifecycle. The snapshot
    is NOISY (the paper's premise: a 1-second sample is a rough sketch
    of stable runtime BW), so a forest fit on pre-shift operation
    learns to denoise via the stable per-pair features — knowledge the
    provider migration silently invalidates: post-shift it keeps
    predicting pre-shift BW (~2x high) no matter what the snapshot
    says. Link fluctuation and host noise stay off so the runs are
    deterministic per seed. With the lifecycle off this is a
    frozen-predictor replay; with it on, the drift detector catches
    the post-shift residual step from free observations, a couple of
    targeted full probes label the harvest window, and the refreshed
    forest recovers residual accuracy a frozen predictor never does
    (`tests/test_torch_lifecycle.py`)."""
    return ScenarioSpec(
        name="provider_shift_drift", steps=40,
        description="DCs 0-3 shift to 0.5x provider at step 15 under "
                    "noisy snapshots; lifecycle=on detects and refits",
        events=(at(15, ProviderShift(factors=(0.5, 0.5, 0.5, 0.5,
                                              1.0, 1.0, 1.0, 1.0))),),
        sim_kwargs=dict(fluct_sigma=0.0, snapshot_sigma=0.45,
                        runtime_sigma=0.0, host_sigma=0.0),
        cfg_kwargs=dict(replan_every=5))


def skew_ramp() -> ScenarioSpec:
    """Data skew ramps onto one DC (§3.3.1): its pairs earn a larger
    share of the connection budget."""
    return ScenarioSpec(
        name="skew_ramp", steps=40,
        description="DC 0's skew weight ramps 1 -> 4 over steps 10-20",
        events=(at(10, SkewRamp(weights=(4.0, 1.0, 1.0, 1.0), over=10)),),
        sim_kwargs=dict(QUIET),
        cfg_kwargs=dict(replan_every=5))


SCENARIOS: Dict[str, Callable[[], ScenarioSpec]] = {
    "steady": steady,
    "diurnal": diurnal,
    "runtime_fluctuation": runtime_fluctuation,
    "congestion": congestion,
    "link_flap": link_flap,
    "cable_cut": cable_cut,
    "cable_cut_reroute": cable_cut_reroute,
    "straggler_host": straggler_host,
    "elastic": elastic,
    "provider_shift": provider_shift,
    "provider_shift_drift": provider_shift_drift,
    "skew_ramp": skew_ramp,
}


def get_scenario(name: str) -> ScenarioSpec:
    """Fresh spec by name (KeyError lists the known names)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name]()


def scenario_names() -> List[str]:
    """All named scenarios, library order."""
    return list(SCENARIOS)
