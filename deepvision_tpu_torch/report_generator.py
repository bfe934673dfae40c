"""Report generation CLI (reference scripts/report_generator.py, 900 LoC):
run the V3 pipeline for sessions outside the web process — batch
re-generation after pipeline upgrades, readiness triage, and measured
reports/min benchmarking.

Counterpart of the JAX package's ``scripts/report_generator.py`` on the
PyTorch port, with the same commands, flags, output lines and exit codes.
In engine mode the gateway's engine runs on a CUDA device unless
``--device cpu`` is passed; without CUDA it raises.

Workflows:
  generate SID [SID...]      one-off generation (optionally --check-ready)
  generate --all             every completed session in scope
  generate --workers 4       thread-pool batch (measures reports/min)
  readiness SID [SID...]     triage which sessions are report-ready
  regenerate --profile quality --all   quality-variant re-runs

Usage:
  python -m deepvision_tpu_torch.report_generator --data-dir data \
      --ai-mode engine generate --all --status completed --workers 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from deepvision_tpu_torch.engine.client import ModelGateway
from deepvision_tpu_torch.web.meta_index import MetaIndex
from deepvision_tpu_torch.web.runtime import report_v3
from deepvision_tpu_torch.web.runtime.followup import report_readiness
from deepvision_tpu_torch.web.stores import (
    ReportStore,
    SessionStore,
    build_session_report_filename,
)


def _services(args):
    meta = MetaIndex(os.path.join(args.data_dir, "meta_index.sqlite3"))
    sessions = SessionStore(args.data_dir, meta)
    reports = ReportStore(args.data_dir, meta)
    gateway = ModelGateway(mode=args.ai_mode)
    if args.ai_mode == "engine":
        from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

        gateway.engines["default"] = LLMEngine(
            EngineConfig(device=args.device))
    return meta, sessions, reports, gateway


def _resolve_session_ids(args, sessions) -> list:
    if getattr(args, "all", False):
        rows, _ = sessions.list_index(None, args.scope, page=1,
                                      page_size=10000)
        ids = [r["session_id"] for r in rows
               if not args.status or r["status"] == args.status]
        return ids
    return list(args.session_ids)


def _generate_one(sid, sessions, reports, gateway, args):
    session = sessions.load(sid)
    if session is None:
        return sid, None, "not found"
    if args.check_ready:
        ready = report_readiness(session)
        if not ready.get("ready", True):
            return sid, None, (
                "not ready: "
                + "; ".join(b.get("detail", b.get("type", "?"))
                            for b in ready.get("blockers", []))
            )
    if args.dry_run:
        return sid, "(dry-run)", None
    result = report_v3.generate_report_v3(
        gateway, session, profile=args.profile
    )
    name = build_session_report_filename(
        session.get("topic", ""), sid,
        variant=args.profile if args.profile != "balanced" else "",
    )
    reports.save(
        name, result.markdown,
        owner_user_id=session.get("owner_user_id"),
        instance_scope=args.scope, session_id=sid,
        topic=session.get("topic", ""), report_profile=args.profile,
    )
    # bind back to the session like the web queue does
    session["last_report_name"] = name
    session["current_report_name"] = name
    session["last_report_quality_meta"] = result.quality
    sessions.save(session)
    detail = (f"quality={result.quality.get('score')} path={result.path} "
              f"attempts={result.draft_attempts} "
              f"reviews={result.review_rounds_run}")
    return sid, name, detail


def cmd_generate(args):
    _, sessions, reports, gateway = _services(args)
    ids = _resolve_session_ids(args, sessions)
    if not ids:
        print("no sessions matched", file=sys.stderr)
        return 1
    t0 = time.time()
    done = 0
    failed = 0

    def run(sid):
        nonlocal done, failed
        try:
            sid, name, detail = _generate_one(
                sid, sessions, reports, gateway, args)
        except Exception as e:  # noqa: BLE001 — batch must not die
            failed += 1
            print(f"{sid}: ERROR {type(e).__name__}: {e}", file=sys.stderr)
            return
        if name is None:
            failed += 1
            print(f"{sid}: skip ({detail})", file=sys.stderr)
        else:
            done += 1
            print(f"{sid} -> {name} ({detail})")

    if args.workers > 1:
        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            list(pool.map(run, ids))
    else:
        for sid in ids:
            run(sid)
    dt = time.time() - t0
    if done and not args.dry_run:
        print(f"\n{done} reports in {dt:.1f}s "
              f"({done / dt * 60:.1f} reports/min, "
              f"workers={args.workers}, failed={failed})")
    return 0 if done else 1


def cmd_readiness(args):
    _, sessions, _, _ = _services(args)
    ids = _resolve_session_ids(args, sessions)
    ready_n = 0
    for sid in ids:
        session = sessions.load(sid)
        if session is None:
            print(f"{sid}: not found", file=sys.stderr)
            continue
        ready = report_readiness(session)
        if ready.get("ready", True):
            ready_n += 1
            print(f"{sid}: READY")
        else:
            reasons = "; ".join(
                b.get("detail", b.get("type", "?")) for b in ready.get("blockers", []))
            print(f"{sid}: blocked — {reasons}")
    print(f"{ready_n}/{len(ids)} ready")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description="report generator")
    p.add_argument("--data-dir", default=os.environ.get(
        "DEEPVISION_DATA_DIR", "data"))
    p.add_argument("--scope", default="default")
    p.add_argument("--ai-mode", default="template",
                   choices=["template", "engine", "off"])
    p.add_argument("--device", default="cuda",
                   help="device of the engine in engine mode (cuda or cpu)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("generate")
    sp.add_argument("session_ids", nargs="*")
    sp.add_argument("--all", action="store_true",
                    help="every session in scope (honors --status)")
    sp.add_argument("--status", default="",
                    help="with --all: filter by session status")
    sp.add_argument("--profile", default="balanced",
                    choices=["balanced", "quality", "release-conservative"])
    sp.add_argument("--workers", type=int, default=1)
    sp.add_argument("--check-ready", action="store_true",
                    help="skip sessions the readiness gate blocks")
    sp.add_argument("--dry-run", action="store_true")
    sp.set_defaults(fn=cmd_generate)

    sp = sub.add_parser("readiness")
    sp.add_argument("session_ids", nargs="*")
    sp.add_argument("--all", action="store_true")
    sp.add_argument("--status", default="")
    sp.set_defaults(fn=cmd_readiness)

    args = p.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
