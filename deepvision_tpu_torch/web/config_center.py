"""Admin config center: typed setting descriptors + config file writers.

Re-implements the reference's admin config service at depth
(``_admin_setting`` descriptors web/server.py:2755-3289, file writers
:3741-3848, service web/server_modules/admin_config_center.py): every
admin-editable key carries a type, group, description, default, and
restart/sensitivity flags; saves are validated and coerced before they
touch the runtime resolver; persistence can target the runtime store, a
``.env`` file (comment-preserving read-modify-write), or the frontend's
``site-config.js``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from deepvision_tpu_torch.web import config as config_defaults


@dataclasses.dataclass(frozen=True)
class SettingDescriptor:
    key: str
    group: str
    type: str = "str"               # str | int | float | bool | choice
    description: str = ""
    choices: Tuple[str, ...] = ()
    sensitive: bool = False         # masked in payloads
    requires_restart: bool = False  # applied only after process restart
    min_value: Optional[float] = None
    max_value: Optional[float] = None

    @property
    def default(self) -> Any:
        return getattr(config_defaults, self.key, None)


def _d(key, group, type="str", desc="", **kw) -> SettingDescriptor:
    return SettingDescriptor(key=key, group=group, type=type,
                             description=desc, **kw)


DESCRIPTORS: List[SettingDescriptor] = [
    # --- ai / engine -------------------------------------------------------
    _d("ENABLE_AI", "ai", "bool", "AI 功能总开关"),
    _d("AI_MODE", "ai", "choice", "AI 后端：template=确定性模板，engine=本地TPU引擎",
       choices=("template", "engine", "off"), requires_restart=True),
    _d("QUESTION_MODEL_NAME", "ai", "str", "问题生成通道模型", requires_restart=True),
    _d("REPORT_MODEL_NAME", "ai", "str", "报告通道模型", requires_restart=True),
    _d("REPORT_DRAFT_MODEL_NAME", "ai", "str", "报告草稿通道模型",
       requires_restart=True),
    _d("REPORT_REVIEW_MODEL_NAME", "ai", "str", "报告评审通道模型",
       requires_restart=True),
    _d("ENGINE_TOKENIZER", "ai", "str", "分词器（auto 按模型自动匹配）",
       requires_restart=True),
    _d("ENGINE_CHECKPOINT_DIR", "ai", "str", "模型权重路径（空=内置检查点）",
       requires_restart=True),
    _d("ENGINE_MAX_SLOTS", "ai", "int", "连续批处理解码槽位数",
       min_value=1, max_value=256, requires_restart=True),
    _d("ENGINE_NUM_PAGES", "ai", "int", "KV 页池大小",
       min_value=64, requires_restart=True),
    _d("ENGINE_PAGE_SIZE", "ai", "int", "KV 页 token 数",
       min_value=16, requires_restart=True),
    _d("ENGINE_MAX_PAGES_PER_SEQ", "ai", "int", "单序列最大页数",
       min_value=1, requires_restart=True),
    _d("ENGINE_TP", "ai", "int", "张量并行度（ICI mesh）",
       min_value=1, max_value=64, requires_restart=True),
    _d("ENGINE_REPLICAS", "ai", "int", "本地引擎副本数（>1 启用路由器）",
       min_value=1, max_value=16, requires_restart=True),
    _d("ENGINE_REMOTE_URLS", "ai", "str", "远程引擎服务地址（逗号分隔，DCN 扩展）",
       requires_restart=True),
    _d("ENGINE_DECODE_STEPS_PER_CALL", "ai", "int",
       "单次调度融合解码步数（K）", min_value=1, max_value=64),
    _d("ENGINE_REPORT_DECODE_STEPS", "ai", "int",
       "报告引擎融合解码步数（吞吐优先，默认 16）",
       min_value=1, max_value=64, requires_restart=True),
    _d("ENGINE_PIPELINE_DECODE", "ai", "bool",
       "流水线解码（设备驻留状态链式调度，隐藏主机同步延迟）",
       requires_restart=True),
    _d("ENGINE_MAX_CHAINED_DECODES", "ai", "int", "链式解码调用上限",
       min_value=2, max_value=32, requires_restart=True),
    _d("ENGINE_CHUNKED_PREFILL", "ai", "bool", "长提示分块预填充",
       requires_restart=True),
    _d("ENGINE_PREFILL_CHUNK_SIZE", "ai", "int", "预填充块大小",
       min_value=64, requires_restart=True),
    _d("ENGINE_QUANTIZE", "ai", "str",
       "推理权重量化（int8 仅权重量化，解码 HBM 流量减半；空=关闭）",
       requires_restart=True),
    _d("ENGINE_KV_QUANTIZE", "ai", "str",
       "KV 缓存页量化（int8：KV 页 DMA 流量减半、并发容量翻倍；空=关闭）",
       requires_restart=True),
    _d("ENGINE_FUSE_PROJECTIONS", "ai", "bool",
       "融合投影矩阵（qkv/gate-up 单次矩阵乘，降低解码算子开销）",
       requires_restart=True),
    # --- strategy / timeouts ------------------------------------------------
    _d("API_TIMEOUT", "strategy", "int", "默认 AI 调用超时（秒）",
       min_value=1, max_value=3600),
    _d("MAX_TOKENS_QUESTION", "strategy", "int", "问题生成 token 上限",
       min_value=64),
    _d("MAX_TOKENS_REPORT", "strategy", "int", "报告生成 token 上限",
       min_value=256),
    _d("MAX_TOKENS_SUMMARY", "strategy", "int", "摘要 token 上限", min_value=32),
    _d("ASSESSMENT_SCORE_MAX_TOKENS", "strategy", "int", "评分 token 上限",
       min_value=16),
    _d("QUESTION_FAST_TIMEOUT", "strategy", "float", "快速档超时（秒）",
       min_value=0.5, max_value=120),
    _d("QUESTION_FAST_MAX_TOKENS", "strategy", "int", "快速档 token 上限",
       min_value=64),
    _d("QUESTION_FAST_PROMPT_BUDGET", "strategy", "int", "快速档提示词预算（字符）",
       min_value=200),
    _d("QUESTION_HEDGE_TRIGGER_DELAY", "strategy", "float",
       "备用通道触发延迟（秒，自适应基线）", min_value=0.1, max_value=30),
    _d("REPORT_API_TIMEOUT", "strategy", "int", "报告管线总超时（秒）",
       min_value=30, max_value=3600),
    # --- context budgets ----------------------------------------------------
    _d("CONTEXT_WINDOW_SIZE", "context", "int", "历史问答滑动窗口",
       min_value=1, max_value=50),
    _d("SUMMARY_THRESHOLD", "context", "int", "触发历史摘要的问答数",
       min_value=2, max_value=100),
    _d("MAX_DOC_LENGTH", "context", "int", "单文档上下文预算（字符）",
       min_value=200),
    _d("MAX_TOTAL_DOCS", "context", "int", "文档上下文总预算（字符）",
       min_value=500),
    _d("DOC_SUMMARY_MIN_CHARS", "context", "int", "触发 AI 摘要的文档长度",
       min_value=200),
    _d("DOC_SUMMARY_TARGET_CHARS", "context", "int", "摘要目标长度",
       min_value=100),
    # --- performance guards -------------------------------------------------
    _d("QUESTION_MAX_INFLIGHT", "performance", "int", "问题生成并发上限",
       min_value=1, max_value=64),
    _d("QUESTION_MAX_PENDING", "performance", "int", "问题生成等待队列上限",
       min_value=1, max_value=256),
    _d("QUESTION_RETRY_AFTER_SECONDS", "performance", "int",
       "429 Retry-After（秒）", min_value=1, max_value=60),
    _d("REPORT_GENERATION_MAX_WORKERS", "performance", "int", "报告工作线程数",
       min_value=1, max_value=16, requires_restart=True),
    _d("REPORT_GENERATION_MAX_PENDING", "performance", "int", "报告等待槽位数",
       min_value=1, max_value=128),
    _d("PREFETCH_IDLE_ONLY", "performance", "bool",
       "预取仅在引擎空闲时执行"),
    _d("LIST_API_DEFAULT_PAGE_SIZE", "performance", "int", "列表默认分页",
       min_value=1, max_value=100),
    _d("LIST_API_MAX_PAGE_SIZE", "performance", "int", "列表最大分页",
       min_value=1, max_value=500),
    # --- uploads ------------------------------------------------------------
    _d("MAX_UPLOAD_BYTES", "uploads", "int", "上传大小上限（字节）",
       min_value=1024),
    _d("DOCUMENT_CONVERT_TIMEOUT_SECONDS", "uploads", "int", "文档转换超时（秒）",
       min_value=5, max_value=600),
    # --- auth ---------------------------------------------------------------
    _d("SECRET_KEY", "auth", "str", "会话签名密钥", sensitive=True,
       requires_restart=True),
    _d("DEBUG_MODE", "auth", "bool", "调试模式（生产必须关闭）",
       requires_restart=True),
    _d("SMS_PROVIDER", "auth", "choice", "短信服务商",
       choices=("mock", "jdcloud")),
    _d("SMS_TEST_CODE", "auth", "str",
       "测试验证码（仅影响签发；DEBUG_MODE=false 时拒绝）", sensitive=True),
    _d("SMS_CODE_TTL_SECONDS", "auth", "int", "验证码有效期（秒）",
       min_value=60, max_value=3600),
    _d("SMS_SEND_COOLDOWN_SECONDS", "auth", "int", "发送冷却（秒）",
       min_value=0, max_value=3600),
    _d("SMS_DAILY_CAP", "auth", "int", "单手机号每日发送上限",
       min_value=1, max_value=1000),
    _d("ADMIN_PHONE_NUMBERS", "auth", "str", "管理员手机号（逗号分隔）",
       sensitive=True),
    _d("ADMIN_USER_IDS", "auth", "str", "管理员用户ID（逗号分隔）"),
    _d("WECHAT_APP_ID", "auth", "str", "微信 AppID"),
    _d("WECHAT_APP_SECRET", "auth", "str", "微信 AppSecret", sensitive=True),
    _d("WECHAT_REDIRECT_URI", "auth", "str", "微信回调地址"),
    # --- license ------------------------------------------------------------
    _d("LICENSE_ENFORCEMENT_ENABLED", "license", "bool", "许可证强制校验"),
    _d("LICENSE_CODE_SIGNING_SECRET", "license", "str", "许可证签名密钥",
       sensitive=True, requires_restart=True),
    # --- storage ------------------------------------------------------------
    _d("DEEPVISION_DATA_DIR", "storage", "str", "数据目录",
       requires_restart=True),
    _d("DATABASE_URL", "storage", "str", "Postgres 连接串（共享存储模式）",
       sensitive=True, requires_restart=True),
    _d("OBJECT_STORAGE_ENDPOINT", "storage", "str", "对象存储端点"),
    _d("OBJECT_STORAGE_BUCKET", "storage", "str", "对象存储桶"),
    _d("OBJECT_STORAGE_ACCESS_KEY", "storage", "str", "对象存储 AccessKey",
       sensitive=True),
    _d("OBJECT_STORAGE_SECRET_KEY", "storage", "str", "对象存储 SecretKey",
       sensitive=True),
    _d("OBJECT_STORAGE_REGION", "storage", "str", "对象存储区域"),
    # --- tenancy / scenarios -----------------------------------------------
    _d("INSTANCE_SCOPE_KEY", "tenancy", "str", "实例隔离键",
       requires_restart=True),
    _d("CONFIG_RESOLUTION_MODE", "tenancy", "choice", "配置解析模式",
       choices=("auto", "hybrid", "env_only"), requires_restart=True),
    # --- report pipeline ----------------------------------------------------
    _d("REPORT_V3_ENABLED", "report", "bool", "V3 报告管线"),
    _d("REPORT_V3_PROFILE", "report", "choice", "报告质量档位",
       choices=("balanced", "quality", "release-conservative")),
    _d("REPORT_V3_MAX_DRAFT_RETRIES", "report", "int", "草稿重试次数",
       min_value=0, max_value=10),
    _d("REPORT_V3_REVIEW_ROUNDS", "report", "int", "评审轮数",
       min_value=0, max_value=5),
    # --- search -------------------------------------------------------------
    _d("WEB_SEARCH_ENABLED", "search", "bool", "联网检索"),
    _d("WEB_SEARCH_MCP_URL", "search", "str", "MCP 检索服务地址"),
    _d("WEB_SEARCH_MCP_KEY", "search", "str", "MCP 检索密钥", sensitive=True),
    # --- presentation -------------------------------------------------------
    _d("PRESENTATION_FEATURE_ENABLED", "presentation", "bool", "演示文稿功能"),
    _d("REFLY_API_URL", "presentation", "str", "Refly 工作流地址"),
    _d("REFLY_API_KEY", "presentation", "str", "Refly 密钥", sensitive=True),
]

BY_KEY: Dict[str, SettingDescriptor] = {d.key: d for d in DESCRIPTORS}

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def coerce(desc: SettingDescriptor, value: Any) -> Any:
    """Validate + coerce ``value`` for ``desc``; raises ValueError."""
    if desc.type == "bool":
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"{desc.key}: 期望布尔值，收到 {value!r}")
    if desc.type in ("int", "float"):
        try:
            out = int(value) if desc.type == "int" else float(value)
        except (TypeError, ValueError):
            raise ValueError(f"{desc.key}: 期望数值，收到 {value!r}")
        if desc.min_value is not None and out < desc.min_value:
            raise ValueError(
                f"{desc.key}: 不得小于 {desc.min_value}（收到 {out}）")
        if desc.max_value is not None and out > desc.max_value:
            raise ValueError(
                f"{desc.key}: 不得大于 {desc.max_value}（收到 {out}）")
        return out
    if desc.type == "choice":
        s = str(value)
        if s not in desc.choices:
            raise ValueError(
                f"{desc.key}: 必须是 {'/'.join(desc.choices)} 之一（收到 {s!r}）")
        return s
    if value is None:
        return ""
    return str(value)


def mask(desc: SettingDescriptor, value: Any) -> Any:
    if not desc.sensitive or value in ("", None):
        return value
    s = str(value)
    if len(s) <= 4:
        return "****"
    return s[:2] + "****" + s[-2:]


def grouped_payload(resolver, runtime_overrides: Dict[str, Any]) -> dict:
    """The GET /api/admin/config-center payload body."""
    groups: Dict[str, list] = {}
    for d in DESCRIPTORS:
        current = resolver.get(d.key)
        groups.setdefault(d.group, []).append({
            "key": d.key,
            "type": d.type,
            "description": d.description,
            "choices": list(d.choices),
            "default": d.default,
            "current_value": mask(d, current),
            "sensitive": d.sensitive,
            "requires_restart": d.requires_restart,
            "runtime_override": d.key in runtime_overrides,
        })
    return groups


def apply_updates(resolver, meta, updates: Dict[str, Any]) -> dict:
    """Validate and apply updates to the runtime resolver + site config
    store.  Returns {applied, errors, restart_required}."""
    applied: Dict[str, Any] = {}
    errors: Dict[str, str] = {}
    restart: List[str] = []
    for key, raw in updates.items():
        desc = BY_KEY.get(key)
        if desc is None:
            errors[key] = "未知配置项"
            continue
        try:
            value = coerce(desc, raw)
        except ValueError as e:
            errors[key] = str(e)
            continue
        resolver.set_runtime(key, value)
        meta.site_config_set(f"cfg:{key}", value)
        applied[key] = mask(desc, value)
        if desc.requires_restart:
            restart.append(key)
    return {"applied": applied, "errors": errors,
            "restart_required": restart}


def restore_runtime_overrides(resolver, meta, skip=()) -> List[str]:
    """At boot, re-apply admin config-center saves persisted in the
    site_config_store (``cfg:<KEY>`` rows) so runtime overrides survive
    restarts — the reference's runtime-value fallback for admin-edited
    keys (web/server.py:454 _runtime_cfg).  Keys in ``skip`` (explicit
    process overrides) are left alone."""
    restored: List[str] = []
    try:
        rows = meta.query(
            "SELECT key, value FROM site_config_store WHERE key LIKE 'cfg:%'"
        )
    except Exception:
        return restored
    skip = set(skip)
    for row in rows:
        key = row["key"][4:]
        desc = BY_KEY.get(key)
        if desc is None or key in skip:
            continue
        try:
            value = coerce(desc, json.loads(row["value"]))
        except (ValueError, json.JSONDecodeError):
            continue
        resolver.set_runtime(key, value)
        restored.append(key)
    return restored


# ---------------------------------------------------------------------------
# File writers (reference web/server.py:3741-3848)
# ---------------------------------------------------------------------------

def _format_env_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


def write_env_file(path: str, updates: Dict[str, Any]) -> List[str]:
    """Comment-preserving read-modify-write of a ``.env`` file.

    Existing ``KEY=...`` lines are rewritten in place; keys not present are
    appended to a managed block at the end.  Returns the list of keys
    written.  Unknown keys in ``updates`` are rejected by the caller
    (``apply_updates``); this writer trusts its input.
    """
    lines: List[str] = []
    if os.path.exists(path):
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    remaining = dict(updates)
    out: List[str] = []
    key_re = re.compile(r"^([A-Z][A-Z0-9_]*)=")
    for line in lines:
        m = key_re.match(line)
        if m and m.group(1) in remaining:
            key = m.group(1)
            out.append(f"{key}={_format_env_value(remaining.pop(key))}")
        else:
            out.append(line)
    if remaining:
        if out and out[-1].strip():
            out.append("")
        out.append("# --- managed by admin config center ---")
        for key in sorted(remaining):
            out.append(f"{key}={_format_env_value(remaining[key])}")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write("\n".join(out) + "\n")
    os.replace(tmp, path)
    return sorted(updates)


def write_site_config_js(path: str, values: Dict[str, Any]) -> None:
    """Emit the frontend's ``site-config.js`` (non-sensitive keys only)."""
    safe = {
        k: v for k, v in values.items()
        if k in BY_KEY and not BY_KEY[k].sensitive
    }
    body = json.dumps(safe, ensure_ascii=False, indent=2, sort_keys=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write("// generated by the admin config center — do not edit\n")
        fh.write(f"window.SITE_CONFIG = {body};\n")
    os.replace(tmp, path)
