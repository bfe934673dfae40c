"""The port's orbax checkpoints against the JAX package's, on the CPU.

Directories written by the JAX ``save_checkpoint`` (orbax with OCDBT, zstd
nodes and chunks) must come back from the port's ``load_checkpoint`` /
``load_or_init`` bit for bit, with and without a template; the port's
``save_checkpoint`` output must come back from the JAX ``load_checkpoint``
bit for bit.  Every comparison is exact (bits of bf16 as uint16): a restore
copies bytes, and the one cast, float32 on disk to a bfloat16 template,
rounds to nearest even in both packages.  The OCDBT reader is also held
against ``tensorstore`` on stores orbax never writes (many versions, small
nodes).  Nothing here needs a card; a CPU load decodes zstd with the plain
decoder only.
"""

import ast
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu_torch.engine import ocdbt, orbax_format, zstd
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
from deepvision_tpu_torch.engine.kernels import zstd as compiled_zstd

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_orbax")


@pytest.fixture(autouse=True)
def _plain_decoder_only(monkeypatch):
    """A CPU load must never reach the compiled decoder."""
    def refuse(*_a, **_k):
        raise AssertionError("a CPU load called the compiled zstd decoder")
    monkeypatch.setattr(compiled_zstd, "decompress", refuse)


def _bits(x) -> np.ndarray:
    """Leaf -> numpy array whose bytes are the leaf's (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _flat(tree, prefix=()):
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from _flat(leaf, prefix + (name,))
        else:
            yield prefix + (name,), leaf


def _assert_same(port_tree, jax_tree):
    got, want = dict(_flat(port_tree)), dict(_flat(jax_tree))
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = _bits(got[k]), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=str(k))


def _mixed_jax():
    """bf16, float32, int32 and int8 leaves, nested."""
    rng = np.random.default_rng(11)
    return {
        "embed": jnp.asarray(rng.standard_normal((33, 16)), jnp.bfloat16),
        "norm": jnp.asarray(rng.standard_normal(16), jnp.float32),
        "ids": {"a": jnp.asarray(rng.integers(-9, 9, (5, 3)), jnp.int32),
                "q8": jnp.asarray(rng.integers(-128, 127, (7, 4)),
                                  jnp.int8)},
    }


def _meta_like(tree):
    return {k: (_meta_like(v) if isinstance(v, dict) else
                torch.empty(v.shape, device="meta", dtype=v.dtype))
            for k, v in tree.items()}


def _to_torch(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_torch(v)
            continue
        a = np.asarray(v)
        if a.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(a.copy())
    return out


# -- JAX writes, the port reads ----------------------------------------------

@pytest.mark.parametrize("tree", ["tiny_test", "mixed"])
def test_port_reads_jax_checkpoints(tmp_path, tree):
    params = (jweights.init_params(TINY_TEST, seed=3) if tree == "tiny_test"
              else _mixed_jax())
    path = str(tmp_path / "ckpt")
    jweights.save_checkpoint(path, params)
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert meta["use_ocdbt"] is True and meta["use_zarr3"] is False
    _assert_same(tweights.load_checkpoint(path, device="cpu"), params)
    template = (tweights.init_params(TINY_TEST, device="meta")
                if tree == "tiny_test" else _meta_like(_to_torch(params)))
    _assert_same(tweights.load_checkpoint(path, template, device="cpu"),
                 params)
    if tree == "tiny_test":
        _assert_same(tweights.load_or_init(TINY_TEST, path, device="cpu"),
                     jweights.load_or_init(TINY_TEST, path))


def test_float32_on_disk_casts_to_bf16_as_jax_does(tmp_path):
    """A float32 checkpoint restored into bf16 ``init_params`` shapes: the
    JAX restore rounds to nearest even, and so must the port (ties,
    subnormals, infinities and NaN included)."""
    rng = np.random.default_rng(5)
    f32 = jax.tree.map(lambda x: x.astype(jnp.float32),
                       jweights.init_params(TINY_TEST, seed=1))
    # exact ties between two bf16 values, either parity, and edge values
    edge = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40,
                     3.4e38, np.inf, -np.inf, np.nan, 0.0, -0.0],
                    np.float32)
    emb = np.asarray(f32["embed"]).copy()
    emb[0, :len(edge)] = edge
    emb[1] = rng.standard_normal(emb.shape[1]).astype(np.float32)
    f32["embed"] = jnp.asarray(emb)
    path = str(tmp_path / "f32")
    jweights.save_checkpoint(path, f32)
    want = jweights.load_or_init(TINY_TEST, path)
    assert want["embed"].dtype == jnp.bfloat16
    got = tweights.load_or_init(TINY_TEST, path, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    _assert_same(got, want)
    # without a template both keep float32
    _assert_same(tweights.load_checkpoint(path, device="cpu"),
                 jweights.load_checkpoint(path))


def test_a_missing_leaf_raises_in_both(tmp_path):
    params = jweights.init_params(TINY_TEST, seed=2)
    del params["blocks"]["wq"]
    path = str(tmp_path / "short")
    jweights.save_checkpoint(path, params)
    with pytest.raises(ValueError, match="tree structures do not match"):
        jweights.load_or_init(TINY_TEST, path)
    with pytest.raises(ValueError, match="tree structures do not match"):
        tweights.load_or_init(TINY_TEST, path, device="cpu")
    # a leaf of another shape raises in the port
    full = str(tmp_path / "full")
    jweights.save_checkpoint(full, jweights.init_params(TINY_TEST, seed=2))
    other = tweights.init_params(TINY_TEST, device="meta")
    other["embed"] = torch.empty(7, 3, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        tweights.load_checkpoint(full, other, device="cpu")


def test_multi_chunk_arrays(tmp_path):
    """Orbax splits an array into zarr chunks of ``chunk_byte_size``; the
    port assembles them, edge chunks included, in both layouts, and fills a
    missing chunk with the fill value as tensorstore does."""
    rng = np.random.default_rng(2)
    tree = {"w": jnp.asarray(rng.standard_normal((50, 37)), jnp.bfloat16),
            "x": jnp.asarray(rng.standard_normal((9, 8, 5)), jnp.float32)}
    args = jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=512), tree)
    for use_ocdbt in (True, False):
        path = str(tmp_path / f"chunked_{use_ocdbt}")
        with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
                use_ocdbt=use_ocdbt)) as ck:
            ck.save(path, args=ocp.args.PyTreeSave(tree, save_args=args))
        reader = orbax_format.CheckpointReader(path, zstd.decompress)
        for keys in reader.leaves:
            z = reader.zarray(keys)
            assert z["chunks"] != z["shape"], z
        _assert_same(tweights.load_checkpoint(path, device="cpu"),
                     jweights.load_checkpoint(path))
    # a chunk missing from the plain layout reads as the fill value, as
    # tensorstore's zarr driver reads it (orbax's restore turns the
    # driver's fill off and raises instead)
    z = json.load(open(os.path.join(path, "w", ".zarray")))
    os.remove(os.path.join(path, "w", "1.0"))
    got = tweights.load_checkpoint(path, device="cpu")
    want = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": os.path.join(path, "w") + "/"}}).result()
    np.testing.assert_array_equal(_bits(got["w"]),
                                  _bits(want.read().result()))
    assert (_bits(got["w"])[z["chunks"][0]:2 * z["chunks"][0],
                            :z["chunks"][1]] == 0).all()


def _copy_into_small_nodes(src: str, dst: str) -> None:
    """Copy an orbax checkpoint with its OCDBT store rewritten through
    tensorstore with 256-byte nodes and inline values up to 64 bytes."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "manifest.ocdbt", "d", "ocdbt.process_*"))
    old = ts.KvStore.open({"driver": "ocdbt",
                           "base": f"file://{src}/"}).result()
    new = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{dst}/",
                           "config": {"max_decoded_node_bytes": 256,
                                      "max_inline_value_bytes": 64}}).result()
    txn = ts.Transaction()
    for key in old.list().result():
        new.with_transaction(txn)[key] = old.read(key).result().value
    txn.commit_async().result()


def test_btree_of_height_one_or_more(tmp_path):
    """Orbax writes its root with ``max_decoded_node_bytes`` 100,000,000,
    so for any tree a test can write the root is one leaf node (2,000
    leaves: height 0); a checkpoint whose store has interior nodes is
    made by rewriting the store with 256-byte nodes.  Its 22 keys (11
    leaves) then sit under a root of height >= 1, which both packages
    read."""
    many = {f"leaf{i:04d}": jnp.full((2,), i, jnp.float32)
            for i in range(2000)}
    wide = str(tmp_path / "wide")
    jweights.save_checkpoint(wide, many)
    store = ocdbt.OcdbtStore(wide, zstd.decompress)
    assert store.height == 0 and len(store.keys()) == 4000
    params = jweights.init_params(TINY_TEST, seed=6)
    src = str(tmp_path / "orbax")
    jweights.save_checkpoint(src, params)
    assert ocdbt.OcdbtStore(src, zstd.decompress).height == 0
    dst = str(tmp_path / "small_nodes")
    _copy_into_small_nodes(src, dst)
    store = ocdbt.OcdbtStore(dst, zstd.decompress)
    assert store.height >= 1 and len(store.keys()) == 22
    _assert_same(tweights.load_checkpoint(dst, device="cpu"), params)
    _assert_same(tweights.load_checkpoint(dst, device="cpu"),
                 jweights.load_checkpoint(dst))


def test_ocdbt_reader_against_tensorstore(tmp_path):
    """Many commits (a version tree with interior nodes), small nodes,
    inline and indirect values, zstd and uncompressed: the port's store
    lists and reads what tensorstore does; a flipped byte fails the
    CRC-32C."""
    rng = np.random.default_rng(4)
    for comp in (None, {"id": "zstd", "level": 3}):
        path = str(tmp_path / f"kv_{comp is None}")
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                              "config": {"compression": comp,
                                         "version_tree_arity_log2": 1,
                                         "max_decoded_node_bytes": 200,
                                         "max_inline_value_bytes": 16}
                              }).result()
        for i in range(20):
            kv[f"group{i % 3}/key{i:03d}"] = rng.bytes(int(rng.integers(
                0, 60)))
        store = ocdbt.OcdbtStore(path, zstd.decompress)
        keys = [k.decode() for k in kv.list().result()]
        assert store.keys() == sorted(keys)
        for k in keys:
            assert store.read(k) == kv.read(k).result().value
        assert store.versions() == list(range(1, 22))
        assert store.height >= 1
    manifest = os.path.join(path, "manifest.ocdbt")
    raw = bytearray(open(manifest, "rb").read())
    raw[len(raw) // 2] ^= 1
    open(manifest, "wb").write(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.OcdbtStore(path, zstd.decompress)


# -- the port writes, JAX reads ----------------------------------------------

@pytest.mark.parametrize("tree", ["tiny_test", "mixed"])
def test_jax_reads_port_checkpoints(tmp_path, tree):
    """The port writes the layout without OCDBT, one uncompressed chunk a
    leaf (``"compressor": null``): the JAX ``load_checkpoint`` restores it
    bit for bit, with and without a template."""
    params = _to_torch(jweights.init_params(TINY_TEST, seed=8)
                       if tree == "tiny_test" else _mixed_jax())
    path = str(tmp_path / "port")
    tweights.save_checkpoint(path, params)
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert meta["use_ocdbt"] is False and meta["use_zarr3"] is False
    for name in ("_CHECKPOINT_METADATA", "_sharding",
                 os.path.join("array_metadatas", "process_0")):
        assert os.path.isfile(os.path.join(path, name)), name
    z = json.load(open(os.path.join(path, "embed", ".zarray")))
    assert z["compressor"] is None and z["chunks"] == z["shape"]
    _assert_same(params, jweights.load_checkpoint(path))
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jweights.load_checkpoint(path))
    _assert_same(params, jweights.load_checkpoint(path, template))
    if tree == "tiny_test":
        _assert_same(params, jweights.load_or_init(TINY_TEST, path))
    # and the port reads its own output back; saving again replaces it
    _assert_same(tweights.load_checkpoint(path, device="cpu"), params)
    tweights.save_checkpoint(path, params)
    _assert_same(tweights.load_checkpoint(path, device="cpu"), params)


# -- the engine --------------------------------------------------------------

def test_engine_boots_from_a_jax_checkpoint_with_the_jax_tokens(tmp_path):
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine

    path = str(tmp_path / "ckpt")
    jweights.save_checkpoint(path, jweights.init_params(TINY_TEST, seed=0))
    tiny = dict(model="dv-tiny-test", tokenizer="byte", max_slots=2,
                num_pages=64, page_size=16, max_pages_per_seq=8, seed=0,
                checkpoint_dir=path)
    prompts = ["orbax checkpoint prompt 检查点", "a second, longer prompt"]
    jeng = JLLMEngine(JEngineConfig(**tiny, interpret=True))
    try:
        want = [jeng.submit_tokens(jeng.tokenizer.encode(p), max_tokens=7,
                                   temperature=0.0).wait(300).token_ids
                for p in prompts]
    finally:
        jeng.shutdown()
    eng = LLMEngine(EngineConfig(**tiny, device="cpu"))
    try:
        got = []
        for p in prompts:
            res = eng.submit_tokens(eng.tokenizer.encode(p), max_tokens=7,
                                    temperature=0.0).wait(300)
            assert res is not None and res.ok, res
            got.append(res.token_ids)
    finally:
        eng.shutdown()
    assert got == want


# -- the committed fixture and the modules -----------------------------------

def test_committed_fixture_equals_its_twin_in_both_packages():
    path = os.path.join(FIXTURES, "tiny_ckpt")
    with np.load(os.path.join(FIXTURES, "tiny_ckpt.npz")) as twin:
        want = {tuple(n[:-len("@bf16")].split("/")): twin[n]
                for n in twin.files}
    jgot = dict(_flat(jweights.load_checkpoint(path)))
    tgot = dict(_flat(tweights.load_checkpoint(path, device="cpu")))
    assert set(jgot) == set(tgot) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(_bits(jgot[k]), w)
        np.testing.assert_array_equal(_bits(tgot[k]), w)


def test_decoder_choice_follows_the_device():
    assert orbax_format.decoder_for("cpu") is zstd.decompress
    assert orbax_format.decoder_for("cuda") is compiled_zstd.decompress
    assert orbax_format.decoder_for(torch.device("cuda", 0)) is \
        compiled_zstd.decompress
    with pytest.raises(ValueError):
        orbax_format.decoder_for("meta")


_FORBIDDEN = ("jax", "deepvision_tpu", "zstandard", "tensorstore", "orbax")


def _imports(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_the_port_imports_no_jax_zstandard_tensorstore_or_orbax():
    """Every module of the port (the new checkpoint modules among them),
    at any depth of each file."""
    files = []
    for root, _, names in os.walk(os.path.join(ROOT, "deepvision_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    new = {"zstd.py", "ocdbt.py", "orbax_format.py", "weights.py",
           "import_hf_checkpoint.py"}
    assert new <= {os.path.basename(f) for f in files}
    bad = {os.path.relpath(f, ROOT): m for f in files for m in _imports(f)
           if m.split(".")[0] in _FORBIDDEN}
    assert not bad
