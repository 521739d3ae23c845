"""Adaptive-fidelity cascade: confidence-gated draft -> verify escalation.

The port's copy of alphafold2_tpu/serving/cascade.py: the same names, messages,
metric names and on-disk formats; Python and numpy only.

The fleet's fidelity ladder (int8 weights, reduced MDS iterations,
capability pools, per-executable prices) was
static per-pool config: every request paid full f32/deep chip cost
regardless of difficulty. This module makes fidelity DYNAMIC (ROADMAP
item 1, HelixFold arxiv 2207.05477 bounds what the cheap arm gets away
with; ParaFold arxiv 2111.06340 motivates spending expensive capacity
only where a cheap pass says it is needed):

  * every cascade-eligible request first runs on the DRAFT pool (a
    normal capability pool the operator points `CascadePolicy.
    draft_pool` at — typically int8 weights, fewer MDS iterations,
    reduced MSA rows, its own buckets/autoscaler);
  * a pluggable `ConfidenceScorer` scores the draft from the signals
    the pipeline already emits — per-residue distogram-entropy
    confidence (`geometry.distogram_confidence`) and the final
    normalized MDS stress — entirely host-side (no extra device work);
  * ACCEPTED drafts resolve the client future as-is (tier="draft");
    rejected drafts ESCALATE: the fleet re-queues the request onto the
    full-fidelity pool with the draft's `FeatureBundle` riding, so
    featurization is never repaid (tier="escalated").

The third lever — trunk-depth early exit (delta-KL-gated recycling that
stops when the distogram stabilizes) — lives in the serving pipeline
(`serving/pipeline.py` `early_exit_depths`/`early_exit_kl`) and is
priced per exit depth as distinct `ExecutableCostLedger` cells
(`serving/engine.py`), so the cost plane's price list reflects what a
shallow answer actually cost.

Cache-tier isolation (the `resolution_tag` invariant family): the
fleet folds the cascade ROLE into each pool's `af2store:` tag, and only
ACCEPTED drafts persist under the draft tag — a draft-tier result can
never alias or serve a full-fidelity hit, and an escalated (rejected)
draft is never stored at all (tests/test_cascade.py pins both ways).

Thread-safety: `CascadeLedger` takes one LEAF lock for its EMA/count
dict ops — never held across a call out, never nested with the fleet
lock (af2lint pass 9 discipline).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional

import numpy as np

_POLICY_KEYS = {
    "draft_pool", "min_confidence", "max_stress", "max_draft_length",
}


@dataclasses.dataclass(frozen=True)
class CascadePolicy:
    """Escalation thresholds — declarative, JSON-loadable like
    `ScalePolicy` (unknown keys reject loudly), validated eagerly.

    A draft is ACCEPTED when its mean per-residue distogram confidence
    reaches `min_confidence` AND (when `max_stress` > 0) its normalized
    MDS stress stays at or under `max_stress`; anything else escalates
    to the full-fidelity tier. `max_draft_length` > 0 sends longer
    sequences straight to the full tier (the draft pool's ladder
    ceiling bounds eligibility regardless)."""

    draft_pool: str = "draft"
    min_confidence: float = 0.5
    max_stress: float = 0.0       # 0 disables the stress leg
    max_draft_length: int = 0     # 0 = draft ladder ceiling decides

    def __post_init__(self):
        if not self.draft_pool:
            raise ValueError("draft_pool must name a capability pool")
        if self.draft_pool == "degraded":
            raise ValueError(
                "draft_pool must not be the reserved degraded tier — the "
                "draft tier is a first-class capability pool with health "
                "management and an autoscaler, not the outage fallback"
            )
        if not 0.0 <= self.min_confidence <= 1.0:
            raise ValueError(
                f"min_confidence must be in [0, 1], got "
                f"{self.min_confidence}"
            )
        if self.max_stress < 0:
            raise ValueError(
                f"max_stress must be >= 0 (0 disables the stress leg), "
                f"got {self.max_stress}"
            )
        if self.max_draft_length < 0:
            raise ValueError(
                f"max_draft_length must be >= 0 (0 defers to the draft "
                f"pool's ladder), got {self.max_draft_length}"
            )
        if self.min_confidence == 0.0 and self.max_stress == 0.0:
            # a gate that can never escalate silently serves every
            # request at draft fidelity — almost certainly a mis-set
            # policy file; demand an explicit threshold
            raise ValueError(
                "cascade policy has no active gate: set min_confidence "
                "> 0 and/or max_stress > 0"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "CascadePolicy":
        unknown = set(d) - _POLICY_KEYS
        if unknown:
            # the faults --check stance: a typo'd knob must not silently
            # leave the default in force
            raise ValueError(
                f"unknown cascade-policy key(s) {sorted(unknown)}; "
                f"known: {sorted(_POLICY_KEYS)}"
            )
        return cls(**d)

    @classmethod
    def from_file(cls, path: str) -> "CascadePolicy":
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclasses.dataclass(frozen=True)
class CascadeVerdict:
    """One draft's scoring outcome. `reason` is a stable label
    ("accepted" / "low_confidence" / "high_stress") — the escalation
    counter's dimension and the /explainz provenance field."""

    accept: bool
    confidence: float
    stress: float
    reason: str


class ConfidenceScorer:
    """Pluggable draft-quality gate: `score(result) -> CascadeVerdict`.

    Implementations must be cheap and host-side (they run on the
    replica completion callback) and must never raise — the fleet
    treats a scorer exception as an escalation (fail toward quality,
    never toward silently serving an unscored draft)."""

    def score(self, result) -> CascadeVerdict:
        raise NotImplementedError


class EntropyStressScorer(ConfidenceScorer):
    """The default gate: mean distogram-entropy confidence
    (`PredictionResult.confidence`, the pLDDT analog) + final
    normalized MDS stress, thresholded by a `CascadePolicy`.

    Scores from the result arrays directly rather than trusting any
    precomputed scalar, so custom engine factories / cache hits score
    identically."""

    def __init__(self, policy: CascadePolicy):
        self.policy = policy

    def score(self, result) -> CascadeVerdict:
        conf_arr = np.asarray(result.confidence, dtype=np.float64)
        conf = float(conf_arr.mean()) if conf_arr.size else 0.0
        stress = float(result.stress)
        if not np.isfinite(conf):
            conf = 0.0
        if conf < self.policy.min_confidence:
            return CascadeVerdict(False, conf, stress, "low_confidence")
        if 0.0 < self.policy.max_stress < stress:
            return CascadeVerdict(False, conf, stress, "high_stress")
        return CascadeVerdict(True, conf, stress, "accepted")


class _TierQuality:
    """Streaming per-tier quality: count + EMA confidence/stress."""

    __slots__ = ("count", "confidence_ema", "stress_ema")

    _ALPHA = 0.2

    def __init__(self):
        self.count = 0
        self.confidence_ema: Optional[float] = None
        self.stress_ema: Optional[float] = None

    def observe(self, confidence: float, stress: float):
        self.count += 1
        self.confidence_ema = (
            confidence if self.confidence_ema is None
            else self._ALPHA * confidence
            + (1 - self._ALPHA) * self.confidence_ema)
        self.stress_ema = (
            stress if self.stress_ema is None
            else self._ALPHA * stress + (1 - self._ALPHA) * self.stress_ema)

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "confidence_ema": (None if self.confidence_ema is None
                               else round(self.confidence_ema, 6)),
            "stress_ema": (None if self.stress_ema is None
                           else round(self.stress_ema, 6)),
        }


class CascadeLedger:
    """The cascade's observability plane: `cascade_*` metric families in
    the fleet registry + the `/statusz` `cascade` section (escalation
    rate and per-tier served quality — the acceptance surface).

    Families (docs/OBSERVABILITY.md inventory):
      cascade_requests_total{tier}     drafts scored / requests served
                                       per terminal tier
      cascade_escalations_total{reason} low_confidence / high_stress /
                                       scorer_error
      cascade_bypass_total{reason}     sent straight to the full tier
                                       (too_long / draft_unavailable)
      cascade_draft_confidence         histogram of draft mean confidence
      cascade_escalation_rate          escalations / scored drafts
      cascade_tier_confidence{tier}    served-quality EMA per tier
      cascade_tier_stress{tier}        served-stress EMA per tier
      cascade_early_exit_total{depth}  early-exited requests per trunk
                                       exit depth
    """

    def __init__(self, registry):
        self._registry = registry
        self._lock = threading.Lock()  # LEAF: dict/EMA ops only
        self._scored = 0
        self._escalated = 0
        self._tiers = {}          # tier -> _TierQuality
        self._served = {}         # tier -> counter (lazy)
        self._escalation = {}     # reason -> counter (lazy)
        self._bypass = {}         # reason -> counter (lazy)
        self._early_exit = {}     # depth -> counter (lazy)
        self._drafts_scored = registry.counter(
            "cascade_requests_total",
            help="cascade requests by tier outcome (draft = scored "
                 "drafts; draft_accepted / escalated / full = terminal "
                 "serves)", tier="draft")
        self._conf_hist = registry.histogram(
            "cascade_draft_confidence",
            help="draft-tier mean distogram confidence, sliding window "
                 "(the escalation gate's input distribution — watch it "
                 "drift when the draft arm regresses)")
        self._rate_gauge = registry.gauge(
            "cascade_escalation_rate",
            help="escalated / scored drafts, lifetime (pegged at 1.0 = "
                 "thresholds mis-set; a sudden spike = draft-quality "
                 "regression — docs/OPERATIONS.md runbook)")

    # ---------------------------------------------------- draft scoring

    def note_scored(self, verdict: CascadeVerdict):
        """One draft passed through the scorer (accept or escalate)."""
        self._drafts_scored.inc()
        self._conf_hist.observe(verdict.confidence)
        with self._lock:
            self._scored += 1
            if not verdict.accept:
                self._escalated += 1
        if not verdict.accept:
            # registry get-or-create is idempotent and takes its own
            # lock; kept OUTSIDE ours so the ledger lock stays a leaf
            counter = self._registry.counter(
                "cascade_escalations_total",
                help="drafts escalated to the full-fidelity tier, by "
                     "gate reason", reason=verdict.reason)
            with self._lock:
                self._escalation.setdefault(verdict.reason, counter)
            counter.inc()
        # the rate is a pure lifetime ratio — refresh the gauge here so a
        # run without the ops ticker (no --ops-port) still snapshots it
        self._rate_gauge.set(self.escalation_rate())

    def note_bypass(self, reason: str):
        """A request sent straight to the full tier without a draft leg
        (too_long: over the draft ladder/max_draft_length; draft_
        unavailable: no healthy draft replica — promoted, never
        starved)."""
        counter = self._registry.counter(
            "cascade_bypass_total",
            help="requests that skipped the draft tier, by reason",
            reason=reason)
        with self._lock:
            self._bypass.setdefault(reason, counter)
        counter.inc()

    def note_served(self, tier: str, *, confidence: float, stress: float,
                    exit_depth: int = 0):
        """One request reached a terminal result at `tier`
        ("draft" / "escalated" / "full"). The served-counter label for
        accepted drafts is "draft_accepted" — tier="draft" is the SCORED
        counter's cell, and sharing it would double-count accepts."""
        label = "draft_accepted" if tier == "draft" else tier
        # registry get-or-create is idempotent and takes its own lock;
        # keep it OUTSIDE ours so the ledger lock stays a true leaf
        counter = self._registry.counter(
            "cascade_requests_total",
            help="cascade requests by tier outcome (draft = scored "
                 "drafts; draft_accepted / escalated / full = terminal "
                 "serves)", tier=label)
        with self._lock:
            self._served.setdefault(label, counter)
            quality = self._tiers.get(tier)
            if quality is None:
                quality = self._tiers[tier] = _TierQuality()
            quality.observe(confidence, stress)
        counter.inc()
        if exit_depth:
            self.note_early_exit(exit_depth)

    def note_early_exit(self, depth: int):
        counter = self._registry.counter(
            "cascade_early_exit_total",
            help="requests whose trunk exited early at this depth "
                 "(delta-KL stabilized; priced as its own cost-ledger "
                 "cell)", depth=str(depth))
        with self._lock:
            self._early_exit.setdefault(depth, counter)
        counter.inc()

    # ------------------------------------------------------ observability

    def escalation_rate(self) -> float:
        with self._lock:
            return self._escalated / self._scored if self._scored else 0.0

    def publish(self):
        """Refresh the gauge families (the fleet's sample_gauges tick)."""
        self._rate_gauge.set(self.escalation_rate())
        with self._lock:
            tiers = {t: (q.confidence_ema, q.stress_ema)
                     for t, q in self._tiers.items()}
        for tier, (conf, stress) in tiers.items():
            if conf is not None:
                self._registry.gauge(
                    "cascade_tier_confidence",
                    help="EMA mean distogram confidence of results "
                         "served at this tier (the per-tier quality "
                         "half of /statusz)", tier=tier).set(conf)
            if stress is not None:
                self._registry.gauge(
                    "cascade_tier_stress",
                    help="EMA normalized MDS stress of results served "
                         "at this tier", tier=tier).set(stress)

    def snapshot(self) -> dict:
        with self._lock:
            tiers = {t: q.snapshot() for t, q in self._tiers.items()}
            scored, escalated = self._scored, self._escalated
            early = {d: int(c.value)
                     for d, c in self._early_exit.items()}
            bypass = {r: int(c.value) for r, c in self._bypass.items()}
            reasons = {r: int(c.value)
                       for r, c in self._escalation.items()}
        return {
            "drafts_scored": scored,
            "escalated": escalated,
            "escalation_rate": round(
                escalated / scored, 6) if scored else 0.0,
            "escalation_reasons": reasons,
            "bypass": bypass,
            "early_exits": early,
            "tiers": tiers,
        }
