"""User levels: experience/standard/professional capability map.

Re-implements the reference capability matrix (web/server.py:8738-9019):
which interview modes, report profiles, exports, and solution/presentation
features each level unlocks.
"""

from __future__ import annotations

from typing import Optional

LEVELS = ("experience", "standard", "professional")

CAPABILITIES = {
    "experience": {
        "interview_modes": ["quick"],
        "report_profiles": ["balanced"],
        "exports": ["markdown"],
        "solution_view": True,
        "solution_share": False,
        "presentation": False,
        "max_sessions": 5,
        "custom_scenarios": False,
    },
    "standard": {
        "interview_modes": ["quick", "standard"],
        "report_profiles": ["balanced", "quality"],
        "exports": ["markdown", "docx"],
        "solution_view": True,
        "solution_share": True,
        "presentation": False,
        "max_sessions": 50,
        "custom_scenarios": True,
    },
    "professional": {
        "interview_modes": ["quick", "standard", "deep"],
        "report_profiles": ["balanced", "quality", "release-conservative"],
        "exports": ["markdown", "docx", "pdf", "appendix"],
        "solution_view": True,
        "solution_share": True,
        "presentation": True,
        "max_sessions": 0,  # unlimited
        "custom_scenarios": True,
    },
}


def capabilities_for(level: Optional[str]) -> dict:
    return dict(CAPABILITIES.get(level or "experience",
                                 CAPABILITIES["experience"]))


def level_allows(level: Optional[str], capability: str, value=None) -> bool:
    caps = capabilities_for(level)
    entry = caps.get(capability)
    if isinstance(entry, bool):
        return entry
    if isinstance(entry, list):
        return value in entry
    if isinstance(entry, int):
        return entry == 0 or (value is not None and value < entry)
    return False


def clamp_interview_mode(level: Optional[str], mode: str) -> str:
    caps = capabilities_for(level)
    return mode if mode in caps["interview_modes"] else caps["interview_modes"][-1]


def clamp_report_profile(level: Optional[str], profile: str) -> str:
    caps = capabilities_for(level)
    return (
        profile if profile in caps["report_profiles"]
        else caps["report_profiles"][-1]
    )
