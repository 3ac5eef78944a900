"""Serving telemetry: request-lifecycle digests, counter streams, and
a median-window regression detector (numpy only; the reference's
``repro/serve/metrics.py``, copied, with the port's ``cow_copies``
counter registered).

The engine stamps every request with its lifecycle on the engine's
virtual clock (``ServeEngine.iters``): ``Request.submit_step`` and
``Request.token_steps`` (the step index that emitted each output
token).  This module turns those stamps — plus per-step snapshots of
``ServeEngine.stats()`` — into the fleet-level numbers the paper's
"millions of inferences per second" story has to be measured in:

  * **TTFT** (time to first token): ``token_steps[0] - submit_step +
    1`` engine steps — how many iterations the request waited through
    (queueing + chunked prefill) before its first output existed.
  * **TPOT** (time per output token): mean inter-token gap
    ``(token_steps[-1] - token_steps[0]) / (n_tokens - 1)`` in steps —
    1.0 is the decode-never-stalls ideal; preemption/resume shows up
    as > 1.
  * **goodput**: completed-request output tokens per engine step —
    tokens that reached a finished request, not padding, not work
    thrown away by preemption-recompute.
  * **queue depth / active slots**: instantaneous gauges sampled per
    step by a traffic harness.

All times are *virtual* (engine steps), so every digest is
deterministic for a deterministic trace — two replays of the same
seeded workload produce byte-identical percentile digests, which is
what lets a serving benchmark gate its rows on them.  Wall-clock
enters only as an explicit, opt-in scale factor (steps/second) that is
never gated.

Counters vs gauges: everything in ``ServeEngine.stats()`` is a
cumulative monotone counter except the instantaneous occupancy gauges
named in ``GAUGES`` — ``counter_deltas`` diffs consecutive snapshots
into per-step rates and passes gauges through unchanged.

``MedianWindowDetector`` flags *sustained* drift in a metric stream
(e.g. a rolling TTFT p99, or per-step queue depth): it freezes a
baseline as the median of the first ``window`` samples, tracks the
median of the trailing ``window``, and only flags after the trailing
median has exceeded ``baseline * (1 + tolerance)`` for ``patience``
consecutive samples — median-of-window so a single spike (one slow
step, one burst head) cannot trip it, patience so the drift must be
sustained.  This is the HomebrewNLP ``wandblog`` discipline: compare
robust window statistics, not raw samples.

The port itself calls only ``summarize`` (with its digest helpers) and
``counter_deltas``.  The drift detector (``MedianWindowDetector``,
``detect_drift``, ``rolling_percentile``) and the sibling, beam and
speculative-decoding counter keys are kept only for parity with the
reference copy, for the traffic harness and engine features still to
be ported.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Sequence

import numpy as np

# The telemetry registry: every key ServeEngine.stats() or the traffic
# harness emits is classified exactly once, as a cumulative monotone
# COUNTER (per-step delta = the meaningful rate) or an instantaneous
# GAUGE (raw reading passes through).  ``counter_deltas`` routes
# strictly through this partition and raises on undeclared keys, so a
# metric added without classifying it here fails loudly.
COUNTERS = frozenset({
    "steps", "prefix_hit_tokens", "scheduled_tokens", "grid_tokens",
    "cow_copies", "scheduled_prefill_tokens", "admitted_prompt_tokens",
    "evictions",
    "preemptions", "swapped_out_blocks", "swapped_in_blocks",
    "swapped_in_tokens", "swap_d2h_fetches", "recompute_tokens",
    "truncated_requests", "finished_requests", "output_tokens",
    "d2h_fetches", "sibling_requests", "beam_forks", "masked_tokens",
    "draft_tokens", "accepted_tokens", "rejected_tokens", "bonus_tokens",
    "draft_d2h_fetches",
})
GAUGES = frozenset({
    "blocks_in_use", "blocks_cached", "preempted_waiting",
    "preemptable_pool", "queue_depth", "active_slots", "step",
})

PERCENTILES = (50, 90, 99)


def percentile_digest(values: Sequence[float], prefix: str = "",
                      qs: Sequence[int] = PERCENTILES,
                      ndigits: int = 4) -> Dict[str, float]:
    """``{prefix}p{q}`` percentiles (linear interpolation — the numpy
    default, deterministic) plus ``{prefix}mean``; NaN-free: empty
    input yields -1.0 sentinels so CSV rows stay comparable."""
    out = {}
    if len(values) == 0:
        for q in qs:
            out[f"{prefix}p{q}"] = -1.0
        out[f"{prefix}mean"] = -1.0
        return out
    arr = np.asarray(values, np.float64)
    if not np.isfinite(arr).all():
        # degenerate lifecycles (0/1-token requests, truncation mid
        # first chunk) must be FILTERED by the caller (ttft_steps /
        # tpot_steps return None there) — a NaN that reaches a digest
        # would flow into CSV rows and the drift detector's medians
        # without ever flagging, so refuse it loudly instead
        raise ValueError(
            f"percentile_digest({prefix or 'values'}) received "
            f"non-finite samples: {arr[~np.isfinite(arr)][:4]}; drop "
            f"degenerate requests before digesting")
    for q in qs:
        out[f"{prefix}p{q}"] = round(float(np.percentile(arr, q)), ndigits)
    out[f"{prefix}mean"] = round(float(arr.mean()), ndigits)
    return out


def ttft_steps(req) -> Optional[int]:
    """Engine steps from submission until the first token existed
    (>= 1; None before the first token)."""
    if not req.token_steps or req.submit_step < 0:
        return None
    return req.token_steps[0] - req.submit_step + 1


def tpot_steps(req) -> Optional[float]:
    """Mean inter-token gap in engine steps (None with < 2 tokens).
    1.0 == the decode-never-stalls ideal; preemption/resume pushes a
    request's mean gap above it."""
    if len(req.token_steps) < 2:
        return None
    return (req.token_steps[-1] - req.token_steps[0]) \
        / (len(req.token_steps) - 1)


def request_digest(requests: Iterable[Any],
                   ndigits: int = 4) -> Dict[str, float]:
    """TTFT/TPOT percentile digest plus completion/truncation counts
    over a set of (finished or in-flight) requests."""
    reqs = list(requests)
    ttfts = [t for t in (ttft_steps(r) for r in reqs) if t is not None]
    tpots = [t for t in (tpot_steps(r) for r in reqs) if t is not None]
    out: Dict[str, float] = {
        "requests": len(reqs),
        "requests_finished": sum(1 for r in reqs if r.done),
        "requests_truncated": sum(1 for r in reqs if r.truncated),
    }
    out.update(percentile_digest(ttfts, "ttft_steps_", ndigits=ndigits))
    out.update(percentile_digest(tpots, "tpot_steps_", ndigits=ndigits))
    return out


def goodput_tokens_per_step(requests: Iterable[Any],
                            steps: int) -> float:
    """Completed-request output tokens per engine step."""
    done_tokens = sum(len(r.out_tokens) for r in requests if r.done)
    return done_tokens / steps if steps else 0.0


def counter_deltas(snapshots: Sequence[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """Per-step deltas of the ``COUNTERS`` keys across consecutive
    snapshots; ``GAUGES`` keys pass through unchanged.  The first
    snapshot is diffed against zero, so the output aligns 1:1 with the
    input steps.

    Routing is strict: a key in neither registry raises ``KeyError``
    (registry drift — a renamed or new metric that nobody classified),
    and a declared counter with a non-integer value raises
    ``TypeError`` (diffing floats silently yields garbage rates);
    passing either through as a gauge would quietly corrupt the rate
    streams."""
    out: List[Dict[str, Any]] = []
    prev: Dict[str, Any] = {}
    for snap in snapshots:
        row: Dict[str, Any] = {}
        for k, v in snap.items():
            if k in GAUGES:
                row[k] = v
            elif k in COUNTERS:
                if not isinstance(v, (int, np.integer)):
                    raise TypeError(
                        f"counter {k!r} has non-integer value {v!r} "
                        f"({type(v).__name__}); counters are monotone "
                        f"integer totals")
                row[k] = int(v) - int(prev.get(k, 0))
            else:
                raise KeyError(
                    f"snapshot key {k!r} is declared in neither "
                    f"COUNTERS nor GAUGES (serve/metrics.py); classify "
                    f"it before emitting it")
        out.append(row)
        prev = snap
    return out


@dataclasses.dataclass
class DriftReport:
    """Outcome of streaming one metric through the detector."""
    flagged: bool
    first_flag_index: int         # -1 when never flagged
    baseline_median: float
    worst_median: float           # max trailing-window median seen

    @property
    def worst_ratio(self) -> float:
        if self.baseline_median == 0:
            return float("inf") if self.worst_median > 0 else 1.0
        return self.worst_median / self.baseline_median


class MedianWindowDetector:
    """Sustained-drift detector over a streamed metric.

    ``update(value)`` returns True while the stream is in a flagged
    state.  Semantics:

    * the BASELINE is the median of the first ``window`` samples —
      frozen once full, so later drift cannot contaminate it;
    * the CURRENT level is the median of the trailing ``window``
      samples — one outlier sample cannot move a median, so spikes
      shorter than ``window // 2`` never register;
    * drift is flagged only after the current level has exceeded
      ``baseline * (1 + tolerance)`` for ``patience`` *consecutive*
      updates — the "sustained p99 drift" contract: regressions must
      hold, not blip.

    Lower-is-better metrics only (latency, queue depth); feed the
    negation for higher-is-better ones.
    """

    def __init__(self, window: int = 16, tolerance: float = 0.25,
                 patience: int = 4):
        assert window >= 1 and patience >= 1
        self.window = window
        self.tolerance = tolerance
        self.patience = patience
        self._head: List[float] = []
        self._tail: Deque[float] = deque(maxlen=window)
        self.baseline: Optional[float] = None
        self.streak = 0
        self.flagged = False
        self.first_flag_index = -1
        self.worst_median = -np.inf
        self._n = 0

    def update(self, value: float) -> bool:
        if not np.isfinite(value):
            # np.median propagates NaN, and NaN comparisons are always
            # False — a NaN sample would silently disarm the detector
            # (baseline or current median poisoned, streak never
            # advances).  Same contract as percentile_digest: the
            # caller filters degenerate lifecycles.
            raise ValueError(
                f"MedianWindowDetector.update received non-finite "
                f"sample {value!r}; filter degenerate requests "
                f"upstream")
        self._n += 1
        self._tail.append(float(value))
        if self.baseline is None:
            self._head.append(float(value))
            if len(self._head) >= self.window:
                self.baseline = float(np.median(self._head))
            return False
        current = float(np.median(self._tail))
        self.worst_median = max(self.worst_median, current)
        if current > self.baseline * (1.0 + self.tolerance):
            self.streak += 1
        else:
            self.streak = 0
        if self.streak >= self.patience:
            if not self.flagged:
                self.first_flag_index = self._n - 1
            self.flagged = True
        return self.streak >= self.patience

    def report(self) -> DriftReport:
        worst = self.worst_median if np.isfinite(self.worst_median) \
            else (self.baseline if self.baseline is not None else 0.0)
        return DriftReport(self.flagged, self.first_flag_index,
                           self.baseline if self.baseline is not None
                           else 0.0, worst)


def detect_drift(series: Sequence[float], window: int = 16,
                 tolerance: float = 0.25,
                 patience: int = 4) -> DriftReport:
    """Stream a whole series through a fresh ``MedianWindowDetector``."""
    det = MedianWindowDetector(window=window, tolerance=tolerance,
                               patience=patience)
    for v in series:
        det.update(v)
    return det.report()


def rolling_percentile(values: Sequence[float], q: int = 99,
                       window: int = 8) -> List[float]:
    """Trailing-window percentile series — e.g. a rolling TTFT p99 in
    request-completion order, the stream the drift detector watches."""
    out: List[float] = []
    buf: Deque[float] = deque(maxlen=window)
    for v in values:
        buf.append(float(v))
        out.append(float(np.percentile(np.asarray(buf), q)))
    return out


def summarize(requests: Iterable[Any], snapshots: Sequence[Dict[str, Any]],
              steps: int, ndigits: int = 4) -> Dict[str, Any]:
    """The headline serving digest: request-lifecycle percentiles,
    goodput, queue-depth/occupancy gauge percentiles, and the final
    counter totals — everything deterministic in virtual time (what
    serving benchmark rows are built from)."""
    reqs = list(requests)
    out: Dict[str, Any] = {"steps": steps}
    out.update(request_digest(reqs, ndigits=ndigits))
    out["goodput_tokens_per_step"] = round(
        goodput_tokens_per_step(reqs, steps), ndigits)
    if snapshots:
        for gauge in ("queue_depth", "active_slots", "blocks_in_use"):
            if gauge in snapshots[0]:
                out.update(percentile_digest(
                    [s[gauge] for s in snapshots], f"{gauge}_",
                    ndigits=ndigits))
        final = snapshots[-1]
        for k in ("scheduled_tokens", "grid_tokens",
                  "scheduled_prefill_tokens", "prefix_hit_tokens",
                  "preemptions", "swapped_out_blocks",
                  "swapped_in_tokens", "recompute_tokens",
                  "truncated_requests", "output_tokens", "evictions"):
            if k in final:
                out[k] = int(final[k])
        # padding efficiency: fraction of launched device-grid rows
        # that carried a real token (1.0 = perfectly packed; the
        # padded (slots, chunk) grid sits near scheduled/(slots*chunk))
        if final.get("grid_tokens"):
            out["padding_efficiency"] = round(
                int(final["scheduled_tokens"])
                / int(final["grid_tokens"]), ndigits)
        # speculative-decoding digest (engines with spec_k > 0 only —
        # draft_tokens stays 0 otherwise and legacy rows are unchanged):
        # acceptance rate is the fraction of proposed draft tokens the
        # target verified; each verify also emits one non-draft token
        # (correction or, when the whole draft survived, the bonus)
        if final.get("draft_tokens"):
            for k in ("draft_tokens", "accepted_tokens",
                      "rejected_tokens", "bonus_tokens"):
                out[k] = int(final[k])
            out["spec_acceptance_rate"] = round(
                int(final["accepted_tokens"])
                / int(final["draft_tokens"]), ndigits)
    return out
