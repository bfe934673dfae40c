"""The port's ops and eval CLIs against the JAX package's scripts.

``deepvision_tpu_torch.report_generator``, ``.eval_generation_quality``
and ``.eval_quant_quality`` are held against ``scripts/report_generator.py``,
``scripts/eval_generation_quality.py`` and ``scripts/eval_quant_quality.py``
on the CPU: the report generator in template mode (subprocesses, twin data
dirs) and in engine mode (one ``dv-tiny-test`` ``.npz`` written by JAX
``init_params``, greedy lanes); the scorers, the gate and the prompt
builders on fixed inputs; ``run_model``'s lanes and dedupe replay over a
recording engine; the int8 A/B's greedy tokens on the tiny model.  Nothing
compared depends on the wall clock: the report's minute stamp, the date in
a report's file name and the reports/min figures are replaced by one
placeholder on both sides after their counts are compared.
"""

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import threading

import pytest
import torch

import bench
import deepvision_tpu.engine.engine as jengine
import deepvision_tpu_torch.engine.engine as tengine
from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu.engine.weights import init_params, save_npz
from deepvision_tpu.web.meta_index import MetaIndex
from deepvision_tpu.web.stores import ReportStore, SessionStore
from deepvision_tpu_torch import eval_generation_quality as t_egq
from deepvision_tpu_torch import eval_quant_quality as t_eqq
from deepvision_tpu_torch import report_generator as t_rg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPLETED = "dv-20260101000000-feed0000"
# render_report_markdown's "生成时间：YYYY-MM-DD HH:MM" (to the minute)
STAMP = re.compile(r"生成时间：\d{4}-\d{2}-\d{2} \d{2}:\d{2}")
# build_session_report_filename's UTC date
NAME_DATE = re.compile(r"-\d{8}-dv-")
# cmd_generate's last line: "N reports in Xs (Y reports/min, ...)"
RATE = re.compile(r"in [0-9.]+s \([0-9.]+ reports/min")
# the engines of the engine-mode tests: the tiny model, with room for the
# A/B's report prompts (1,269 bytes) and a K=16 decode call untruncated
TINY_ENGINE = dict(model="dv-tiny-test", tokenizer="byte", max_slots=2,
                   num_pages=200, page_size=16, max_pages_per_seq=96)
MAX_TOKENS = 24
GOLDEN_NEW = 7   # the greedy window of tests/test_engine_golden.py


def _load_script(name):
    """``scripts/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_cli_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


j_rg = _load_script("report_generator")
j_egq = _load_script("eval_generation_quality")
j_eqq = _load_script("eval_quant_quality")


def _seed(data_dir):
    """The ops CLIs' data dir of ``tests/test_ops_scripts.py``: two
    sessions written through the store, one completed."""
    os.makedirs(data_dir, exist_ok=True)
    meta = MetaIndex(os.path.join(data_dir, "meta_index.sqlite3"))
    store = SessionStore(data_dir, meta)
    for i, status in enumerate(["completed", "in_progress"]):
        store.save({
            "session_id": f"dv-2026010100000{i}-feed000{i}",
            "topic": f"CLI测试主题{i}",
            "status": status,
            "instance_scope": "default",
            "owner_user_id": "u1",
            "interview_mode": "standard",
            "scenario_id": "product-requirement",
            "created_at": "2026-01-01T00:00:00Z",
            "updated_at": "2026-01-01T00:00:00Z",
            "interview_log": [
                {"question": "现状如何？", "answer": "高峰期单据积压严重，"
                 "主要卡在审批环节", "dimension": "d1",
                 "quality_score": 0.8},
                {"question": "目标是什么？", "answer": "两小时内处理完",
                 "dimension": "d1", "quality_score": 0.5},
            ],
            "dimensions": {"d1": {"coverage": 1.0}},
            "reference_materials": [],
        })
    return data_dir


def _saved(data_dir):
    """The completed session's report binding, its quality meta and the
    report's markdown."""
    meta = MetaIndex(os.path.join(data_dir, "meta_index.sqlite3"))
    session = SessionStore(data_dir, meta).load(COMPLETED)
    name = session["last_report_name"]
    report = ReportStore(data_dir, meta).load(name)
    return name, session["last_report_quality_meta"], report


def _unstamped(text):
    return NAME_DATE.sub("-<date>-dv-", STAMP.sub("生成时间：<stamp>", text))


def _same_reports(t_report, j_report):
    """Equal reports but for the minute stamp, which must occur as often
    in both."""
    assert t_report and j_report
    assert len(STAMP.findall(t_report)) == len(STAMP.findall(j_report))
    assert _unstamped(t_report) == _unstamped(j_report)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, init_params(TINY_TEST, seed=0))
    return path


@pytest.fixture()
def tiny_engines(tiny_npz, tmp_path, monkeypatch):
    """Both packages' ``EngineConfig``, as the CLIs look it up, build the
    tiny model from the ``.npz`` (JAX: Pallas in interpret mode); every
    other field is the CLI's own."""
    monkeypatch.setenv("DV_DFA_CACHE_DIR", str(tmp_path / "dfa"))

    def patched(real, **extra):
        return lambda **kw: real(**{**kw, **TINY_ENGINE,
                                    "checkpoint_dir": tiny_npz, **extra})

    monkeypatch.setattr(jengine, "EngineConfig",
                        patched(jengine.EngineConfig, interpret=True))
    monkeypatch.setattr(tengine, "EngineConfig",
                        patched(tengine.EngineConfig))


# -- report_generator ---------------------------------------------------------

def _run_cli(argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)


def test_report_generator_template_mode_equals_the_jax_cli(tmp_path):
    """``test_ops_scripts.py::test_report_generator_batch_and_readiness``
    on the port's CLI (``--device cpu``), beside the JAX CLI on a twin data
    dir: the same output lines and exit codes, the same report bound to
    the same session with the same quality meta."""
    runs = {}
    for side, argv in (
            ("port", ["-m", "deepvision_tpu_torch.report_generator"]),
            ("jax", [os.path.join(ROOT, "scripts", "report_generator.py")])):
        data_dir = _seed(str(tmp_path / side))
        extra = ["--device", "cpu"] if side == "port" else []
        ready = _run_cli([*argv, "--data-dir", data_dir, *extra,
                          "readiness", "--all"])
        gen = _run_cli([*argv, "--data-dir", data_dir, *extra, "generate",
                        "--all", "--status", "completed", "--workers", "2"])
        runs[side] = (ready, gen, _saved(data_dir))
    (t_ready, t_gen, t_saved), (j_ready, j_gen, j_saved) = (runs["port"],
                                                            runs["jax"])
    assert t_ready.returncode == 0, t_ready.stderr
    assert "READY" in t_ready.stdout
    assert (t_ready.returncode, t_ready.stdout) == (j_ready.returncode,
                                                    j_ready.stdout)
    assert t_gen.returncode == 0, t_gen.stderr
    assert "reports/min" in t_gen.stdout
    assert len(RATE.findall(t_gen.stdout)) == len(RATE.findall(j_gen.stdout))
    assert (_unstamped(RATE.sub("<rate>", t_gen.stdout))
            == _unstamped(RATE.sub("<rate>", j_gen.stdout)))
    assert (t_gen.returncode, t_gen.stderr) == (j_gen.returncode,
                                                j_gen.stderr)
    (t_name, t_quality, t_report), (j_name, j_quality, j_report) = (t_saved,
                                                                    j_saved)
    assert t_name and t_quality
    assert _unstamped(t_name) == _unstamped(j_name)
    assert t_quality == j_quality
    _same_reports(t_report, j_report)


def _engine_mode_report(mod, data_dir, device):
    """One report through ``mod``'s own ``_services`` in engine mode, the
    lanes greedy with a short budget and a deadline no CPU call reaches;
    every model call is recorded."""
    args = argparse.Namespace(
        data_dir=data_dir, scope="default", ai_mode="engine", device=device,
        check_ready=False, dry_run=False, profile="balanced")
    _, sessions, reports, gateway = mod._services(args)
    gateway.lanes = {k: v.replace(temperature=0.0, max_tokens=MAX_TOKENS,
                                  timeout_s=600.0)
                     for k, v in gateway.lanes.items()}
    calls = []
    inner = gateway.call_model

    def recording(prompt, call_type="question", *, return_meta=False, **kw):
        text, meta = inner(prompt, call_type, return_meta=True, **kw)
        calls.append((call_type, prompt, text, meta.get("prompt_shrunk")))
        return (text, meta) if return_meta else text

    gateway.call_model = recording
    try:
        sid, name, detail = mod._generate_one(COMPLETED, sessions, reports,
                                              gateway, args)
    finally:
        for eng in gateway.engines.values():
            eng.shutdown()
    assert (sid, name) == (COMPLETED, _saved(data_dir)[0])
    return detail, calls, _saved(data_dir)


def test_report_generator_engine_mode_equals_the_jax_cli(tmp_path,
                                                        tiny_engines):
    """``_generate_one`` of both CLIs on the same tiny weights: the same
    model calls and texts, report markdown, path, draft attempts and
    quality meta."""
    t_detail, t_calls, (t_name, t_quality, t_report) = _engine_mode_report(
        t_rg, _seed(str(tmp_path / "port")), "cpu")
    j_detail, j_calls, (j_name, j_quality, j_report) = _engine_mode_report(
        j_rg, _seed(str(tmp_path / "jax")), "cpu")
    assert [c[0] for c in t_calls].count("report_draft") >= 1
    assert not any(c[3] for c in t_calls + j_calls)    # no shrunk prompt
    assert t_calls == j_calls
    # "quality=... path=... attempts=... reviews=..."
    assert "path=" in t_detail and t_detail == j_detail
    assert t_quality == j_quality
    assert _unstamped(t_name) == _unstamped(j_name)
    _same_reports(t_report, j_report)


# -- eval_generation_quality --------------------------------------------------

def _question(q, **kw):
    d = {"question": q, "options": ["甲", "乙", "丙"], "multi_select": False,
         "answer_mode": "pick_only", "requires_rationale": False,
         "evidence_intent": "low"}
    d.update(kw)
    return json.dumps(d, ensure_ascii=False)


QUESTION_OUTS = [
    {"text": _question("现有流程的瓶颈在哪？"), "tokens": 60},
    {"text": _question("现有流程的瓶颈在哪？"), "tokens": 61},    # duplicate
    {"text": _question("预算范围？", answer_mode="free"), "tokens": 40},
    {"text": _question("谁审批？", evidence_intent="extreme"), "tokens": 45},
    {"text": _question("长" * 241), "tokens": 300},
    {"text": _question("选项太多？", options=list("abcdefg")), "tokens": 70},
    {"text": _question("只有一个选项？", options=["a"]), "tokens": 30},
    {"text": json.dumps({"question": "缺字段？"}, ensure_ascii=False),
     "tokens": 12},
    {"text": json.dumps({"question": ""}), "tokens": 5},
    {"text": '{"question": "未闭合', "tokens": 220},
    {"text": "", "tokens": 0},
]


def _draft(**kw):
    d = {
        "overview": "概述",
        "needs": [{"title": "需求一", "refs": ["Q1", "Q2"]},
                  {"title": "需求二", "refs": ["Q9"]}, "非字典项"],
        "analysis": "分析",
        "visualizations": {"flow": "graph TD\nA-->B",
                           "bad": "not a diagram", "empty": ""},
        "solutions": [{"title": "方案", "refs": ["Q3"]}],
        "risks": [{"title": "风险", "refs": []}],
        "actions": [{"title": "行动", "refs": ["Q1", "QX"]}],
        "open_questions": ["待确认"],
        "evidence_index": [{"q": "Q1"}],
    }
    d.update(kw)
    return json.dumps(d, ensure_ascii=False)


REPORT_OUTS = [
    ({"text": _draft(), "tokens": 900}, ["Q1", "Q2", "Q3"]),
    ({"text": _draft(risks=[]), "tokens": 700}, ["Q1", "Q2"]),
    ({"text": json.dumps({"overview": "只有概述"}, ensure_ascii=False),
      "tokens": 100}, ["Q1"]),
    ({"text": _draft(needs=[{"title": f"n{k}", "refs": ["Q1"]}
                            for k in range(6)]), "tokens": 1200},
     ["Q1", "Q2"]),
    ({"text": '{"overview": "截断', "tokens": 1500}, ["Q1"]),
    ({"text": _draft(visualizations={"seq": "sequenceDiagram\nA->>B: hi"}),
      "tokens": 800}, ["Q1", "Q3"]),
]


def test_eval_constants_and_prompt_builders_equal_the_jax_cli():
    for name in ("TOPICS", "DIMS", "A2_REQUIRED", "DRAFT_KEYS"):
        assert getattr(t_egq, name) == getattr(j_egq, name), name
    assert t_egq.question_prompts(30) == j_egq.question_prompts(30)
    assert t_egq.report_prompts(30) == j_egq.report_prompts(30)
    for i in range(6):
        for n_facts in (1, 8, 12):
            assert (t_eqq.report_prompt(i, n_facts)
                    == bench.report_prompt(i, n_facts))
    assert t_eqq.build_prompts(5) == j_eqq.build_prompts(5)


def test_eval_scorers_equal_the_jax_cli():
    outs = [o for o, _ in REPORT_OUTS]
    q_ids = [q for _, q in REPORT_OUTS]
    for k in range(1, len(QUESTION_OUTS) + 1):
        assert (t_egq.score_questions(QUESTION_OUTS[:k])
                == j_egq.score_questions(QUESTION_OUTS[:k]))
        for o in QUESTION_OUTS[:k]:
            assert t_egq._question_text(o) == j_egq._question_text(o)
    for k in range(1, len(outs) + 1):
        assert (t_egq.score_reports(outs[:k], q_ids[:k])
                == j_egq.score_reports(outs[:k], q_ids[:k]))
    got = t_egq.score_questions(QUESTION_OUTS)
    # the fixed texts reach every branch: valid, invalid, duplicate
    assert 0 < got["schema_valid_pct"] < got["json_parse_pct"] < 100
    assert got["distinct_question_pct"] < 100
    rep = t_egq.score_reports(outs, q_ids)
    assert 0 < rep["section_complete_pct"] < rep["schema_valid_pct"] < 100
    assert 0 < rep["refs_resolve_pct"] < 100
    assert 0 < rep["mermaid_valid_pct"] < 100


@pytest.mark.parametrize("schema_valid", [None, 95.0, 89.9])
def test_eval_gate_equals_the_jax_cli(tmp_path, schema_valid):
    path = str(tmp_path / "eval.json")
    if schema_valid is not None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"n_per_model": 4, "sampling": "T=0.7 top_k=40",
                       "dv-fast": {"lane": "question",
                                   "schema_valid_pct": schema_valid},
                       "dv-base": {"lane": "report",
                                   "schema_valid_pct": 100.0},
                       "dv-mini": {"error": "no checkpoint"}}, fh)
    results = []
    for mod in (t_egq, j_egq):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.gate(path, 90.0)
        results.append((rc, buf.getvalue()))
    assert results[0] == results[1]
    assert results[0][0] == (1 if schema_valid == 89.9 else 0)


class _RecordingEngine:
    """Stands in for ``LLMEngine`` in ``run_model``: a prompt's k-th draw
    is a function of the model, the prompt and k alone, so two runs whose
    threads interleave differently get the same texts.  First questions
    collide (one of three), redraws do not."""

    configs = []

    def __init__(self, cfg):
        self.cfg = cfg
        self.draws = {}
        self.lock = threading.Lock()
        _RecordingEngine.configs.append(cfg)

    def start(self):
        pass

    def shutdown(self):
        pass

    def generate_text(self, prompt, **kw):
        with self.lock:
            k = self.draws[prompt] = self.draws.get(prompt, 0) + 1
        h = int(hashlib.sha1(prompt.encode("utf-8")).hexdigest(), 16)
        if self.cfg.model == "dv-fast":        # the question lane
            text = _question(f"问题{h % 3}" if k == 1 else f"重抽{h % 97}-{k}")
        else:
            text = _draft(needs=[{"title": "n", "refs": ["Q1"]}] * (h % 4))
        return text, {"completion_tokens": 50 + h % 100 + k}


def _eval_main(mod, argv, monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["eval", *argv])
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv) if mod is not j_egq else mod.main()
    return rc, buf.getvalue()


def test_eval_generation_quality_main_equals_the_jax_cli(monkeypatch):
    """Both CLIs' ``main`` over the recording engine: the same lanes, scores,
    dedupe resamples and output; a model without a checkpoint gives
    ``{"error": "no checkpoint"}``; the port passes ``--device``."""
    monkeypatch.setattr(jengine, "LLMEngine", _RecordingEngine)
    monkeypatch.setattr(tengine, "LLMEngine", _RecordingEngine)
    _RecordingEngine.configs = []
    argv = ["--n", "9", "--models",
            "dv-fast:question,dv-base:report,dv-none:question",
            "--max-report-tokens", "512"]
    t_rc, t_out = _eval_main(t_egq, [*argv, "--device", "cpu"], monkeypatch)
    t_configs, _RecordingEngine.configs = _RecordingEngine.configs, []
    j_rc, j_out = _eval_main(j_egq, argv, monkeypatch)
    assert (t_rc, t_out) == (j_rc, j_out) and t_rc == 0
    results = json.loads(t_out[t_out.index("\n{\n") + 1:])
    assert results["dv-none"] == {"error": "no checkpoint"}
    assert results["dv-fast"]["dedupe_resamples"] > 0
    assert results["dv-base"]["lane"] == "report"
    assert [c.device for c in t_configs] == ["cpu", "cpu"]
    assert [c.model for c in t_configs] == ["dv-fast", "dv-base"]


# -- eval_quant_quality -------------------------------------------------------

def test_eval_quant_quality_tokens_equal_the_jax_cli(tiny_engines,
                                                     monkeypatch):
    """Both CLIs' ``main`` on the tiny weights at T=0 over the greedy
    window: ``run_lane`` gives the same texts and token counts in the bf16
    and the int8 lane, and ``main`` the same JSON line."""
    lanes = {}
    for name, mod in (("port", t_eqq), ("jax", j_eqq)):
        def recording(*a, _real=mod.run_lane, _outs=lanes.setdefault(
                name, []), **kw):
            _outs.append(_real(*a, **kw))
            return _outs[-1]

        monkeypatch.setattr(mod, "run_lane", recording)
    argv = ["--model", "dv-tiny-test", "--n", "2", "--max-tokens",
            str(GOLDEN_NEW)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_eqq.main([*argv, "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["eval_quant_quality.py", *argv])
        j_eqq.main()
    assert len(lanes["port"]) == 2                    # bf16, then int8
    assert lanes["port"] == lanes["jax"]
    for outs in lanes["port"]:
        assert [o["tokens"] for o in outs] == [GOLDEN_NEW] * 2, outs
    t_line, j_line = buf.getvalue().splitlines()
    assert t_line == j_line
    assert json.loads(t_line)["n_prompts"] == 2


# -- isolation and devices ----------------------------------------------------

def test_cli_modules_import_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "import deepvision_tpu_torch.report_generator\n"
        "import deepvision_tpu_torch.eval_generation_quality\n"
        "import deepvision_tpu_torch.eval_quant_quality\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'deepvision_tpu' or m.startswith('deepvision_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("cli", ["report_generator", "eval_generation_quality",
                                 "eval_quant_quality"])
def test_cli_without_device_cpu_raises_without_cuda(cli, tmp_path,
                                                    monkeypatch):
    """No CPU fallback: with no CUDA and no ``--device cpu``, the engine the
    CLI builds raises through ``resolve_device``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "report_generator": ["--data-dir", _seed(str(tmp_path / "d")),
                             "--ai-mode", "engine", "readiness", "--all"],
        "eval_generation_quality": ["--n", "1", "--models",
                                    "dv-fast:question"],
        "eval_quant_quality": ["--n", "1", "--max-tokens", "1"],
    }[cli]
    mod = {"report_generator": t_rg, "eval_generation_quality": t_egq,
           "eval_quant_quality": t_eqq}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
