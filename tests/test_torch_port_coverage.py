"""The port's public surface against the JAX package's, read as text.

Every public top-level ``def`` or ``class`` of every module under
``deepvision_tpu/`` must have a top-level ``def`` or ``class`` of the same
name in the port's module at the same path under ``deepvision_tpu_torch/``,
and every ``add_argument`` flag (and subcommand) of the JAX package's CLI
scripts must exist in the port's CLI of the same name.  The names that
have a counterpart under another name sit in :data:`COUNTERPARTS`, each
with that counterpart and the reason.  Both packages are parsed with
``ast``; neither is imported.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "deepvision_tpu"
PORT_PKG = ROOT / "deepvision_tpu_torch"
CLI_SCRIPTS = ("train_model", "report_generator", "eval_generation_quality",
               "eval_quant_quality", "import_hf_checkpoint")

# (JAX module, public name or None for the whole module) -> (the port's
# counterpart as "module::name", why it has another name)
COUNTERPARTS = {
    ("engine/parallel.py", "named_shardings"): (
        ["engine/parallel.py::ShardPlan", "engine/parallel.py::shard_params"],
        "JAX-only: it maps PartitionSpecs to NamedShardings of a device "
        "mesh.  Each rank of the port holds its own shard, cut by "
        "ShardPlan's per-leaf dims in shard_params."),
    ("engine/tokenizer.py", "HFTokenizer"): (
        ["engine/tokenizer.py::BPETokenizer"],
        "HFTokenizer wraps HF `tokenizers`, which the card's machine lacks; "
        "BPETokenizer reads the same tokenizer files in plain Python."),
    ("native/__init__.py", None): (
        ["web/runtime/documents.py::chunk_markdown_bytes",
         "engine/tokenizer.py::BPETokenizer"],
        "the C++ chunker and batch encoder: the port chunks in Python "
        "(chunk_markdown_bytes) and encodes through its tokenizers' "
        "encode_batch."),
}


def _top_level(path: pathlib.Path) -> dict:
    """The module's top-level ``def``/``class`` nodes by name."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _public(path: pathlib.Path) -> set:
    return {name for name in _top_level(path) if not name.startswith("_")}


def _jax_modules() -> list:
    return sorted(str(p.relative_to(JAX_PKG))
                  for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_has_a_counterpart(module):
    if (module, None) in COUNTERPARTS:
        assert not (PORT_PKG / module).exists()
        return
    port = PORT_PKG / module
    assert port.exists(), f"no port of deepvision_tpu/{module}"
    have = set(_top_level(port))
    want = _public(JAX_PKG / module)
    missing = {name for name in want - have
               if (module, name) not in COUNTERPARTS}
    assert not missing, f"deepvision_tpu/{module}: {sorted(missing)}"


@pytest.mark.parametrize("key", sorted(COUNTERPARTS, key=str))
def test_counterpart_table_is_exact(key):
    """Each entry names a JAX name that exists and that the port lacks
    under that name, and a counterpart that exists in the port."""
    module, name = key
    counterparts, reason = COUNTERPARTS[key]
    assert reason
    if name is None:
        assert _public(JAX_PKG / module)
        assert not (PORT_PKG / module).exists()
    else:
        assert name in _public(JAX_PKG / module)
        assert name not in _top_level(PORT_PKG / module)
    for ref in counterparts:
        path, attr = ref.split("::")
        assert attr in _top_level(PORT_PKG / path), ref


def test_tokenizer_counterparts_batch_encode():
    """``native.encode_batch``'s counterpart is a method of the port's
    tokenizers."""
    classes = _top_level(PORT_PKG / "engine" / "tokenizer.py")
    for cls in ("ByteTokenizer", "BPETokenizer"):
        methods = {n.name for n in classes[cls].body
                   if isinstance(n, ast.FunctionDef)}
        assert "encode_batch" in methods, cls


def _cli(path: pathlib.Path) -> set:
    """Every string argument of ``add_argument`` (flags and positional
    names) and of ``add_parser`` (subcommands)."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    return {a.value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in ("add_argument", "add_parser")
            for a in n.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)}


@pytest.mark.parametrize("script", CLI_SCRIPTS)
def test_every_cli_flag_has_a_counterpart(script):
    want = _cli(ROOT / "scripts" / f"{script}.py")
    got = _cli(PORT_PKG / f"{script}.py")
    assert want, script
    assert want <= got, f"{script}: {sorted(want - got)}"
    # the port adds only its device choice
    assert got - want <= {"--device"}, sorted(got - want)
