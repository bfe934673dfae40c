"""Strategy defaults — the re-implementation of reference web/config.py.

Key names match the reference so deployments/tests migrate unchanged
(reference web/config.py + web/.env.example's 107 keys; the AI-gateway keys
are re-pointed at local engine settings instead of remote endpoints).
"""

# --- AI / engine (replaces ANTHROPIC_* remote gateway keys) ---------------
ENABLE_AI = True
AI_MODE = "template"            # template | engine | off
# "auto" resolves to the best in-repo trained checkpoint (dv-fast on the
# question lanes, dv-base on the report lanes, falling back to dv-mini);
# the "auto" tokenizer pairs each model with the BPE vocab it was trained
# on.  The defaults below are the JAX app's, key for key.
QUESTION_MODEL_NAME = "auto"
REPORT_MODEL_NAME = "auto"
REPORT_DRAFT_MODEL_NAME = "auto"
REPORT_REVIEW_MODEL_NAME = "auto"
ENGINE_TOKENIZER = "auto"
ENGINE_CHECKPOINT_DIR = ""
ENGINE_MAX_SLOTS = 32  # small-model KV is cheap; 32 slots halves queue waits
ENGINE_NUM_PAGES = 1024
ENGINE_PAGE_SIZE = 64
ENGINE_MAX_PAGES_PER_SEQ = 32
ENGINE_TP = 1
ENGINE_REPLICAS = 1              # local replicas per model (router when >1)
ENGINE_REMOTE_URLS = ""          # comma list of remote engine services (DCN)
ENGINE_DECODE_STEPS_PER_CALL = 8
# throughput-bound report engines use a longer fused decode window
ENGINE_REPORT_DECODE_STEPS = 16
# chain fused decode calls from device-resident state (engine/scheduler.py
# ``_decode_step_pipelined``); off by default, as in the JAX app.
ENGINE_PIPELINE_DECODE = False
ENGINE_MAX_CHAINED_DECODES = 4
ENGINE_CHUNKED_PREFILL = True
ENGINE_PREFILL_CHUNK_SIZE = 256
# Weight-only int8 serving quantization ("int8" | "", engine/quant.py).
ENGINE_QUANTIZE = ""
# int8 KV page pools ("int8" | ""): static per-(layer, kv-head) scales
# calibrated at engine boot (engine/kv_cache.py).  Off by default.
ENGINE_KV_QUANTIZE = ""
# Fuse wq|wk|wv and w_gate|w_up into single serving matmuls
# (engine/fuse.py).  Off by default.
ENGINE_FUSE_PROJECTIONS = False

# --- timeouts / token caps (reference web/config.py:55-109) ---------------
API_TIMEOUT = 120
MAX_TOKENS_QUESTION = 2200
MAX_TOKENS_REPORT = 8000
MAX_TOKENS_SUMMARY = 600
ASSESSMENT_SCORE_MAX_TOKENS = 160
QUESTION_FAST_TIMEOUT = 8.0
QUESTION_FAST_MAX_TOKENS = 900
QUESTION_FAST_PROMPT_BUDGET = 2200
QUESTION_HEDGE_TRIGGER_DELAY = 1.2
REPORT_API_TIMEOUT = 210

# --- context budgets (reference web/config.py:71-83) ----------------------
CONTEXT_WINDOW_SIZE = 5
SUMMARY_THRESHOLD = 8
MAX_DOC_LENGTH = 1800
MAX_TOTAL_DOCS = 5000
DOC_SUMMARY_MIN_CHARS = 1400
DOC_SUMMARY_TARGET_CHARS = 700

# --- concurrency guards (reference web/server.py:548-571) -----------------
QUESTION_MAX_INFLIGHT = 2
QUESTION_MAX_PENDING = 10
QUESTION_RETRY_AFTER_SECONDS = 2
REPORT_GENERATION_MAX_WORKERS = 2
REPORT_GENERATION_MAX_PENDING = 16
PREFETCH_IDLE_ONLY = True

# --- list APIs (reference web/server.py:528-534) --------------------------
LIST_API_DEFAULT_PAGE_SIZE = 20
LIST_API_MAX_PAGE_SIZE = 100

# --- uploads --------------------------------------------------------------
MAX_UPLOAD_BYTES = 10 * 1024 * 1024
DOCUMENT_CONVERT_TIMEOUT_SECONDS = 60

# --- auth / security ------------------------------------------------------
SECRET_KEY = "dev-secret-change-me"
DEBUG_MODE = True
SMS_PROVIDER = "mock"           # mock | jdcloud
SMS_TEST_CODE = ""
SMS_CODE_TTL_SECONDS = 300
SMS_SEND_COOLDOWN_SECONDS = 60
SMS_DAILY_CAP = 20
ADMIN_PHONE_NUMBERS = ""
ADMIN_USER_IDS = ""
WECHAT_APP_ID = ""
WECHAT_APP_SECRET = ""
WECHAT_REDIRECT_URI = ""

# --- license --------------------------------------------------------------
LICENSE_ENFORCEMENT_ENABLED = False
LICENSE_CODE_SIGNING_SECRET = ""

# --- storage --------------------------------------------------------------
DEEPVISION_DATA_DIR = "data"
META_INDEX_DB_PATH = ""          # default: <data>/meta_index.sqlite3
AUTH_DB_PATH = ""                # default: <data>/auth/auth.sqlite3
LICENSE_DB_PATH = ""             # default: <data>/auth/license.sqlite3
DATABASE_URL = ""                # postgres:// enables shared-store mode
OBJECT_STORAGE_ENDPOINT = ""
OBJECT_STORAGE_BUCKET = ""
OBJECT_STORAGE_ACCESS_KEY = ""
OBJECT_STORAGE_SECRET_KEY = ""
OBJECT_STORAGE_REGION = "us-east-1"

# --- scenarios / tenancy --------------------------------------------------
BUILTIN_SCENARIOS_DIR = ""       # default: <pkg>/resources/scenarios/builtin
CUSTOM_SCENARIOS_DIR = ""        # default: <data>/custom_scenarios
INSTANCE_SCOPE_KEY = "default"

# --- config resolution ----------------------------------------------------
CONFIG_RESOLUTION_MODE = "auto"  # auto | hybrid | env_only

# --- report pipeline ------------------------------------------------------
REPORT_V3_ENABLED = True
REPORT_V3_PROFILE = "balanced"   # balanced | quality | release-conservative
REPORT_V3_MAX_DRAFT_RETRIES = 2
REPORT_V3_REVIEW_ROUNDS = 1

# --- search ---------------------------------------------------------------
WEB_SEARCH_ENABLED = False
WEB_SEARCH_MCP_URL = ""
WEB_SEARCH_MCP_KEY = ""

# --- presentation (Refly) -------------------------------------------------
PRESENTATION_FEATURE_ENABLED = False
REFLY_API_URL = ""
REFLY_API_KEY = ""
