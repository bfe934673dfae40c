"""``python -m deepvision_tpu_torch.import_hf_checkpoint`` against
``scripts/import_hf_checkpoint.py``.

A tiny random ``transformers`` Llama, saved with ``save_pretrained`` to a
temporary directory (nothing is downloaded), goes through both CLIs: their
stdout and ``model_config.json`` must be equal, and each package must read
the other's orbax directory bit for bit (exact: both round float32 to bf16
to nearest even, and a restore copies bytes).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from deepvision_tpu.engine import weights as jweights  # noqa: E402
from deepvision_tpu_torch import import_hf_checkpoint as cli  # noqa: E402
from deepvision_tpu_torch.engine import weights as tweights  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128,
             rms_norm_eps=1e-5, rope_theta=10000.0,
             tie_word_embeddings=False, attention_bias=False)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**LLAMA))
    path = str(tmp_path_factory.mktemp("hf") / "tiny-llama")
    model.save_pretrained(path)
    return path


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=()):
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from _flat(leaf, prefix + (name,))
        else:
            yield prefix + (name,), _bits(leaf)


def _same(a, b):
    a, b = dict(_flat(a)), dict(_flat(b))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def _run_both(*argvs):
    """Run the commands side by side; their stdouts, in order.  USE_TF=0
    keeps ``transformers`` from importing TensorFlow, which neither CLI
    uses."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", USE_TF="0")
    procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


def _json(path):
    with open(os.path.join(path, "model_config.json")) as fh:
        return fh.read()


def test_both_clis_agree(hf_dir, tmp_path):
    """bfloat16 (the default) through both CLIs as processes."""
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    want, got = _run_both(
        ["scripts/import_hf_checkpoint.py", hf_dir, jax_out],
        ["-m", "deepvision_tpu_torch.import_hf_checkpoint", hf_dir,
         port_out])
    assert got.replace(port_out, "OUT") == want.replace(jax_out, "OUT")
    assert got.splitlines()[-1] == f"saved to {port_out}"
    assert _json(port_out) == _json(jax_out)
    assert json.loads(_json(port_out))["n_kv_heads"] == 2
    port_reads_jax = tweights.load_checkpoint(jax_out, device="cpu")
    jax_reads_port = jweights.load_checkpoint(port_out)
    _same(port_reads_jax, jweights.load_checkpoint(jax_out))
    _same(jax_reads_port, tweights.load_checkpoint(port_out, device="cpu"))
    _same(port_reads_jax, jax_reads_port)
    assert dict(_flat(port_reads_jax))[("embed",)].dtype == np.uint16


def test_float32_and_the_same_arguments(hf_dir, tmp_path, capsys,
                                        monkeypatch):
    """``--dtype float32`` through both ``main``s in this process, and the
    same argument parser (``--help``)."""
    import runpy

    jax_out, port_out = str(tmp_path / "jax32"), str(tmp_path / "port32")
    monkeypatch.setattr(sys, "argv", ["import_hf_checkpoint.py", hf_dir,
                                      jax_out, "--dtype", "float32"])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(ROOT, "scripts",
                                    "import_hf_checkpoint.py"),
                       run_name="__main__")
    assert done.value.code == 0
    want = capsys.readouterr().out.replace(jax_out, "OUT")
    assert cli.main([hf_dir, port_out, "--dtype", "float32"]) == 0
    assert capsys.readouterr().out.replace(port_out, "OUT") == want
    assert _json(port_out) == _json(jax_out)
    got = tweights.load_checkpoint(port_out, device="cpu")
    assert got["embed"].dtype == torch.float32
    _same(got, jweights.load_checkpoint(jax_out))
    _same(jweights.load_checkpoint(port_out),
          tweights.load_checkpoint(jax_out, device="cpu"))
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    port_help = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["import_hf_checkpoint.py", "--help"])
    with pytest.raises(SystemExit):
        runpy.run_path(os.path.join(ROOT, "scripts",
                                    "import_hf_checkpoint.py"),
                       run_name="__main__")
    jax_help = capsys.readouterr().out
    assert port_help.split("usage:")[1].split()[1:] == \
        jax_help.split("usage:")[1].split()[1:]
    assert port_help.split("\n", 1)[1] == jax_help.split("\n", 1)[1]
    assert jax.default_backend() == "cpu"
