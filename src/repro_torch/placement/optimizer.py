"""BW-aware task placement search (paper §2, §5's latency/cost tables).

A placement assigns each shuffle stage a per-DC task-fraction vector.
The search minimizes the estimated query makespan under a given
achievable-BW matrix, preferring lower egress cost among near-equal
makespans (the paper's placements cut latency up to 26% AND cost up to
16% — latency first, dollars as the tie-break within `rel_tol`).

Three deterministic searches, no RNG anywhere (placement traces must
byte-replay):

  * `greedy_place` — data-proportional start, then coarse+fine
    mass-move local search (move `delta` of one stage's fraction from
    DC a to DC b whenever it helps);
  * `exhaustive_place` — the reference optimum on a fraction grid for
    N <= 4 (tests pin the greedy search against it);
  * `initial_placement` — the Iridium-style leave-data-in-place
    baseline both start from.

The hot path is BATCHED: every round's feasible moves are materialized
as one ``[M, S, N]`` candidate tensor (base placement + sparse ±delta
updates, no per-move copies) and priced in a single
:func:`repro.placement.cost.estimate_cost_batch` launch; only the
winner's full breakdown is built from the scalar reference. Searches
are written as generators yielding candidate tensors, so
:func:`search_many` can drive many jobs' searches in lock-step and fuse
same-shape rounds into shared evaluator launches (the fleet tick path).
Decisions are byte-identical to the historical one-`estimate_cost`-
per-move search (`tests/test_placement_batch.py` pins the goldens).

Port of `repro/placement/optimizer.py`; the drivers take the ``torch``
backend's `device` beside `backend`.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import (Any, Dict, Generator, Iterator, List, Optional, Tuple,
                    Union)

import numpy as np

from repro_torch.placement.cost import (INSTANCE_USD_PER_HOUR, PlacementCost,
                                  _eval_packed, estimate_cost,
                                  estimate_cost_batch, pack_query,
                                  placement_backend)
from repro_torch.placement.query import QuerySpec

EXHAUSTIVE_CHUNK = 4096       # candidate rows per exhaustive-grid launch


@dataclass(frozen=True)
class PlacementDecision:
    """A search result: the placement, its estimated cost, and how many
    cost evaluations the search spent."""

    placement: Tuple[Tuple[float, ...], ...]    # [n_shuffles, N]
    cost: PlacementCost
    evals: int

    def frac(self) -> np.ndarray:
        """The placement as a mutable [n_shuffles, N] array."""
        return np.asarray(self.placement, np.float64)


def _better_vals(mk_a: float, eg_a: float, mk_b: float, eg_b: float,
                 rel_tol: float = 0.01) -> bool:
    """:func:`better` on raw (makespan, egress) values — what the
    batched rounds compare without building cost objects."""
    if mk_a < mk_b * (1.0 - rel_tol):
        return True
    return mk_a <= mk_b * (1.0 + rel_tol) and eg_a < eg_b * (1.0 - 1e-9)


def better(a: PlacementCost, b: PlacementCost,
           rel_tol: float = 0.01) -> bool:
    """True when `a` beats `b` as a *candidate within one round*:
    makespan lower by more than `rel_tol`, or makespan within the band
    and egress strictly cheaper. This orders candidate moves (dollars
    break latency near-ties); *acceptance* of a move over the current
    placement always requires a strict makespan improvement, so the
    egress preference can never walk the latency uphill."""
    return _better_vals(a.makespan_s, a.egress_usd,
                        b.makespan_s, b.egress_usd, rel_tol)


def initial_placement(query: QuerySpec) -> np.ndarray:
    """Data-proportional start ([n_shuffles, N]): every stage keeps
    tasks where the input partitions sit (Iridium's default), which is
    also the egress-friendly anchor the local search refines from."""
    inputs = query.inputs()
    total = inputs.sum()
    frac = inputs / total if total > 0 else np.ones(query.n) / query.n
    return np.tile(frac, (query.n_shuffles(), 1))


def _moves(placement: np.ndarray, delta: float
           ) -> Tuple[np.ndarray, List[Tuple[int, int, int]]]:
    """Materialize every feasible (stage, src, dst, delta) mass move of
    one round as a single candidate tensor.

    Returns ``(cands [M,S,N], moves)`` where row m is the base
    placement with ``delta`` moved from `moves[m] = (s, a, b)` —
    built with one allocation plus two sparse scatters instead of M
    per-move copies. Enumeration order (stage, src, dst) matches the
    historical scalar search, so sequential tie-breaks are unchanged.
    """
    S, n = placement.shape
    moves: List[Tuple[int, int, int]] = []
    for s in range(S):
        for a in range(n):
            if placement[s, a] < delta - 1e-12:
                continue
            for b in range(n):
                if a != b:
                    moves.append((s, a, b))
    M = len(moves)
    cands = np.broadcast_to(placement, (M, S, n)).copy()
    if M:
        mv = np.asarray(moves, np.intp)
        idx = np.arange(M)
        cands[idx, mv[:, 0], mv[:, 1]] -= delta
        cands[idx, mv[:, 0], mv[:, 2]] += delta
    return cands, moves


# A search generator yields candidate tensors [M,S,N] and receives the
# batch's (makespan_s [M], egress_usd [M]) back; its return value is
# (final placement, evals spent).
SearchGen = Generator[np.ndarray, Tuple[np.ndarray, np.ndarray],
                      Tuple[np.ndarray, int]]


def _greedy_gen(placement: np.ndarray, coarse: float, fine: float,
                rel_tol: float, max_rounds: int) -> SearchGen:
    """The greedy search as a batch-request generator: steepest-descent
    rounds at coarse then fine granularity (latency-strict acceptance,
    egress breaks near-ties via :func:`_better_vals`), then the
    anchored egress-polish walk along the converged-makespan plateau.
    One yield per round prices every feasible move at once."""
    evals = 0
    best_mk = best_eg = None
    for delta in (coarse, fine):
        if delta <= 0:
            continue
        mks, egs = yield placement[None]        # price the current start
        evals += 1
        best_mk, best_eg = float(mks[0]), float(egs[0])
        for _ in range(max_rounds):
            cands, moves = _moves(placement, delta)
            if not moves:
                break
            mks, egs = yield cands
            evals += len(moves)
            # acceptance is latency-strict; `_better_vals` then picks
            # the round winner in enumeration order (deterministic)
            cand: Optional[int] = None
            for i in np.nonzero(mks < best_mk * (1.0 - 1e-9))[0]:
                if cand is None or _better_vals(mks[i], egs[i],
                                                mks[cand], egs[cand],
                                                rel_tol):
                    cand = int(i)
            if cand is None:
                break
            s, a, b = moves[cand]
            placement[s, a] -= delta
            placement[s, b] += delta
            best_mk, best_eg = float(mks[cand]), float(egs[cand])
    if best_mk is None:             # search disabled: price the baseline
        mks, egs = yield placement[None]
        evals += 1
        best_mk, best_eg = float(mks[0]), float(egs[0])
    if fine > 0:
        # walk the makespan plateau toward cheaper egress: the anchored
        # bound never ratchets, and egress strictly decreases each
        # accepted move, so this terminates
        anchor = best_mk * (1.0 + 1e-9)
        for _ in range(max_rounds):
            cands, moves = _moves(placement, fine)
            if not moves:
                break
            mks, egs = yield cands
            evals += len(moves)
            ok = (mks <= anchor) & (egs < best_eg * (1.0 - 1e-12))
            cand = None
            for i in np.nonzero(ok)[0]:
                if cand is None or (egs[i], mks[i]) < (egs[cand],
                                                       mks[cand]):
                    cand = int(i)
            if cand is None:
                break
            s, a, b = moves[cand]
            placement[s, a] -= fine
            placement[s, b] += fine
            best_mk, best_eg = float(mks[cand]), float(egs[cand])
    return placement, evals


def _compositions(levels: int, n: int) -> Iterator[Tuple[int, ...]]:
    """All length-`n` tuples of non-negative ints summing to `levels`."""
    if n == 1:
        yield (levels,)
        return
    for head in range(levels + 1):
        for tail in _compositions(levels - head, n - 1):
            yield (head,) + tail


def _exhaustive_gen(query: QuerySpec, levels: int,
                    chunk: int = EXHAUSTIVE_CHUNK) -> SearchGen:
    """The composition-grid reference as a batch-request generator:
    the grid is priced in chunked launches, and each chunk's winner is
    the first index attaining the chunk-minimal (makespan, egress)
    pair (stable lexsort == the historical sequential strict-< scan)."""
    grid = np.asarray(list(_compositions(levels, query.n)),
                      np.float64) / levels                   # [K, N]
    S = query.n_shuffles()
    evals = 0
    best: Optional[Tuple[float, float]] = None
    best_p: Optional[np.ndarray] = None
    combos = itertools.product(range(len(grid)), repeat=S)
    while True:
        idx = np.asarray(list(itertools.islice(combos, chunk)), np.intp)
        if not len(idx):
            break
        cands = grid[idx]                                    # [m, S, N]
        mks, egs = yield cands
        evals += len(idx)
        # plain lexicographic (makespan, egress) — transitive, so the
        # reference optimum is enumeration-order independent
        w = int(np.lexsort((egs, mks))[0])
        if best is None or (float(mks[w]), float(egs[w])) < best:
            best = (float(mks[w]), float(egs[w]))
            best_p = cands[w]
    return best_p, evals


# ----------------------------------------------------------------------
# drivers — one search, or many in lock-step
# ----------------------------------------------------------------------
@dataclass
class SearchTask:
    """One placement search to drive: the query, the achievable-BW
    matrix it prices against, and the search knobs. `gen` defaults to
    the greedy search; :func:`search_many` batches rounds of many tasks
    into shared evaluator launches."""

    query: QuerySpec
    bw: np.ndarray
    egress_usd_per_gb: Any = None
    coarse: float = 0.1
    fine: float = 0.02
    rel_tol: float = 0.01
    max_rounds: int = 200
    gen: Optional[SearchGen] = field(default=None, repr=False)

    def start(self) -> SearchGen:
        """Build (once) and return the underlying search generator."""
        if self.gen is not None and self.gen.gi_frame is None:
            raise ValueError(
                "this SearchTask's search already ran to completion; "
                "build a fresh SearchTask to search again")
        if self.gen is None:
            self.gen = _greedy_gen(initial_placement(self.query),
                                   self.coarse, self.fine, self.rel_tol,
                                   self.max_rounds)
        return self.gen


def _finish(task: SearchTask, placement: np.ndarray,
            evals: int) -> PlacementDecision:
    """Build the winner's full breakdown — the one scalar
    :func:`estimate_cost` call of the whole search."""
    cost = estimate_cost(task.query, placement, task.bw,
                         egress_usd_per_gb=task.egress_usd_per_gb)
    return PlacementDecision(
        placement=tuple(tuple(float(v) for v in row) for row in placement),
        cost=cost, evals=evals)


def _drive_single(task: SearchTask, backend: Optional[str],
                  device=None) -> PlacementDecision:
    """Run one search generator to completion against the backend."""
    gen = task.start()
    try:
        req = next(gen)
        while True:
            batch = estimate_cost_batch(
                task.query, req, task.bw,
                egress_usd_per_gb=task.egress_usd_per_gb,
                backend=backend, device=device)
            req = gen.send((batch.makespan_s, batch.egress_usd))
    except StopIteration as stop:
        placement, evals = stop.value
    return _finish(task, placement, evals)


def search_many(tasks: List[SearchTask], backend: Optional[str] = None,
                device=None) -> List[PlacementDecision]:
    """Drive many searches in lock-step, fusing each round's candidate
    tensors into shared evaluator launches.

    Tasks whose pending requests share a (n_shuffles, N) shape are
    concatenated along the candidate axis and priced in ONE packed
    backend call (per-candidate bw/price/speed/stage rows — bit-exact
    per row, so fusing never changes a decision); tasks with different
    shapes fall into separate groups. This is the fleet-tick path: J
    jobs' per-tick searches cost rounds-many launches total instead of
    J independent Python searches (`fleet/controller.py`). `device` is
    the ``torch`` backend's (None = CUDA).
    """
    backend = placement_backend(backend)
    gens = [t.start() for t in tasks]
    pending: Dict[int, np.ndarray] = {}
    results: Dict[int, PlacementDecision] = {}
    for i, gen in enumerate(gens):
        try:
            pending[i] = next(gen)
        except StopIteration as stop:
            results[i] = _finish(tasks[i], *stop.value)
    while pending:
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, req in pending.items():
            groups.setdefault(req.shape[1:], []).append(i)
        replies: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for members in groups.values():
            if backend == "scalar" or len(members) == 1:
                for i in members:
                    b = estimate_cost_batch(
                        tasks[i].query, pending[i], tasks[i].bw,
                        egress_usd_per_gb=tasks[i].egress_usd_per_gb,
                        backend=backend, device=device)
                    replies[i] = (b.makespan_s, b.egress_usd)
                continue
            sizes = [len(pending[i]) for i in members]
            cands = np.concatenate([pending[i] for i in members])
            n = cands.shape[2]
            bw3 = np.concatenate([
                np.broadcast_to(tasks[i].bw[None], (m, n, n))
                for i, m in zip(members, sizes)])
            packs = [pack_query(tasks[i].query,
                                tasks[i].egress_usd_per_gb)
                     for i in members]
            packed = {key: np.concatenate([
                np.broadcast_to(p[key][None],
                                (m,) + p[key].shape)
                for p, m in zip(packs, sizes)])
                for key in packs[0]}
            batch = _eval_packed(cands, bw3, packed,
                                 INSTANCE_USD_PER_HOUR, backend, device)
            lo = 0
            for i, m in zip(members, sizes):
                replies[i] = (batch.makespan_s[lo:lo + m],
                              batch.egress_usd[lo:lo + m])
                lo += m
        nxt: Dict[int, np.ndarray] = {}
        for i, reply in replies.items():
            try:
                nxt[i] = gens[i].send(reply)
            except StopIteration as stop:
                results[i] = _finish(tasks[i], *stop.value)
        pending = nxt
    return [results[i] for i in range(len(tasks))]


# ----------------------------------------------------------------------
# public searches
# ----------------------------------------------------------------------
def greedy_place(query: QuerySpec, bw_mbps: np.ndarray, *,
                 egress_usd_per_gb: Union[float, np.ndarray, None] = None,
                 coarse: float = 0.1, fine: float = 0.02,
                 rel_tol: float = 0.01,
                 max_rounds: int = 200,
                 backend: Optional[str] = None,
                 device=None) -> PlacementDecision:
    """Greedy reducer placement + local-search refinement: start from
    the data-proportional baseline, descend with `coarse` mass moves,
    polish with `fine` ones, then consolidate free (plateau) mass
    toward cheaper egress without giving back any converged makespan.
    Deterministic; O(rounds * S * N^2) cost evaluations, batched one
    launch per round (`backend` and `device` as in
    :func:`estimate_cost_batch`)."""
    task = SearchTask(query=query,
                      bw=np.asarray(bw_mbps, np.float64),
                      egress_usd_per_gb=egress_usd_per_gb,
                      coarse=coarse, fine=fine, rel_tol=rel_tol,
                      max_rounds=max_rounds)
    return _drive_single(task, backend, device)


def exhaustive_place(query: QuerySpec, bw_mbps: np.ndarray, *,
                     egress_usd_per_gb: Union[float, np.ndarray,
                                              None] = None,
                     levels: int = 5,
                     backend: Optional[str] = None,
                     device=None) -> PlacementDecision:
    """Reference optimum on the fraction grid `{0, 1/levels, ...}` —
    every per-stage composition, every stage combination, priced in
    chunked batches. Exponential; guarded to N <= 4 (its job is to pin
    `greedy_place` in tests)."""
    if query.n > 4:
        raise ValueError(
            f"exhaustive reference is for N <= 4 DCs (got {query.n}); "
            f"use greedy_place for larger meshes")
    task = SearchTask(query=query,
                      bw=np.asarray(bw_mbps, np.float64),
                      egress_usd_per_gb=egress_usd_per_gb,
                      gen=_exhaustive_gen(query, levels))
    return _drive_single(task, backend, device)
