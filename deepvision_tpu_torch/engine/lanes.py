"""Generation lanes: named profiles over local engine replicas.

A copy of the JAX package's ``engine/lanes.py`` over the port's scheduler
priorities.

The reference ran 8 remote "lanes", each an Anthropic-compatible client with
its own key/base-url/model (reference web/server.py:15164-15640, lane config
web/.env.example:36-84).  Locally a lane is a *generation profile*: which
engine replica, token cap, timeout, scheduler priority, and sampling
defaults.  Lane -> call_type resolution mirrors the reference's
(web/server.py:2033-2407) so the app metrics/meta contract is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from deepvision_tpu_torch.engine.scheduler import HIGH, LOW


@dataclasses.dataclass(frozen=True)
class LaneProfile:
    name: str
    engine: str = "default"        # key into the engine registry
    max_tokens: int = 1024
    timeout_s: float = 120.0
    priority: int = HIGH
    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.95

    def replace(self, **kw) -> "LaneProfile":
        return dataclasses.replace(self, **kw)


# Token caps / timeouts track the reference's operational envelope
# (BASELINE.md: question 2200 tok, report 8000, summary 600; fast-tier
# 8 s / 900 tok at web/config.py:98-100).
DEFAULT_LANES: Dict[str, LaneProfile] = {
    "question": LaneProfile(
        "question", max_tokens=2200, timeout_s=60.0, priority=HIGH
    ),
    "question_fast": LaneProfile(
        "question_fast", max_tokens=900, timeout_s=8.0, priority=HIGH
    ),
    "question_deep": LaneProfile(
        "question_deep", max_tokens=2200, timeout_s=90.0, priority=HIGH
    ),
    "report": LaneProfile(
        "report", max_tokens=8000, timeout_s=210.0, priority=HIGH
    ),
    "report_draft": LaneProfile(
        "report_draft", max_tokens=8000, timeout_s=210.0, priority=HIGH
    ),
    "report_review": LaneProfile(
        "report_review", max_tokens=4000, timeout_s=120.0, priority=HIGH
    ),
    "summary": LaneProfile(
        "summary", max_tokens=600, timeout_s=60.0, priority=LOW,
        temperature=0.3,
    ),
    "search_decision": LaneProfile(
        "search_decision", max_tokens=200, timeout_s=15.0, priority=LOW,
        temperature=0.0,
    ),
    "assessment": LaneProfile(
        "assessment", max_tokens=160, timeout_s=30.0, priority=LOW,
        temperature=0.0,
    ),
}

# call_type -> (primary lane, fallback lane) — the reference's lane
# resolution + failover pairing (web/server.py:2033-2407, failover at
# :23451 and interview_runtime.py hedging).
CALL_TYPE_LANES: Dict[str, tuple] = {
    "question": ("question", "question_deep"),
    "question_fast": ("question_fast", "question"),
    "question_deep": ("question_deep", "question"),
    "report": ("report", "report_draft"),
    "report_draft": ("report_draft", "report"),
    "report_review": ("report_review", "report_draft"),
    "summary": ("summary", None),
    "doc_summary": ("summary", None),
    "search_decision": ("search_decision", None),
    "assessment": ("assessment", None),
    "scenario": ("question", "question_deep"),
    "chat": ("question", None),
    "solution_copy": ("report", "report_draft"),
}


def resolve_lanes(
    call_type: str, preferred_lane: Optional[str] = None
) -> list:
    """Ordered candidate lane names for a call type."""
    primary, fallback = CALL_TYPE_LANES.get(
        call_type, ("question", None)
    )
    order = []
    if preferred_lane and preferred_lane in DEFAULT_LANES:
        order.append(preferred_lane)
    for lane in (primary, fallback):
        if lane and lane not in order:
            order.append(lane)
    return order
