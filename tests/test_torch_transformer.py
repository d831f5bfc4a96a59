"""The port's TransformerLM inference against the JAX package's, and the
checkpoint zip both ways.

A small LM (vocab 64, 2 blocks, d_model 64, 4 heads, max_len 64) is
built by the JAX package; its weights reach the port through
``params_from_numpy`` and through a zip written by the JAX
``save_model``.  ``output`` probabilities agree at atol 1e-5 (f32, sums
in another order).  A zip the port writes loads in the JAX package with
the same outputs.  Also here: import hygiene of the port and the rule
that its entry points never fall back to the CPU unasked.
"""

import ast
import io
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.utils.serializer import load_model as j_load
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch.models.transformer import (
    PositionalEmbedding, TransformerBlock, TransformerLM,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.utils.serializer import (
    CheckpointIntegrityError, load_model, save_model,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deeplearning4j_tpu_torch")
SIZE = dict(vocab_size=64, n_layers=2, d_model=64, n_heads=4, max_len=64)
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def jnet():
    return JLM(**SIZE)


@pytest.fixture(scope="module")
def jzip(jnet, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_lm.zip")
    j_save(jnet, path)
    return path


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, SIZE["vocab_size"], (b, t))


def _jax_tree(net):
    return jax.tree_util.tree_map(np.asarray, net.params)


@pytest.mark.parametrize("t", [64, 20], ids=["tiles", "ragged"])
def test_output_matches_jax_from_numpy_params(jnet, t):
    x = _tokens(2, t, seed=t)
    want = np.asarray(jnet.output(x))
    net = TransformerLM(**SIZE, device="cpu")
    net.params = params_from_numpy(_jax_tree(jnet), device="cpu")
    got = net.output(x)
    assert tuple(got.shape) == (2, t, SIZE["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_output_matches_jax_from_jax_zip(jnet, jzip):
    x = _tokens(3, 64, seed=1)
    net = load_model(jzip, device="cpu")
    assert [type(l).__name__ for l in net.conf.layers] == [
        type(l).__name__ for l in jnet.conf.layers]
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)), **TOL)
    # the zip's weights arrive bit for bit
    for pj, pt in zip(_jax_tree(jnet), params_to_numpy(net.params)):
        assert pj.keys() == pt.keys()
        for k in pj:
            np.testing.assert_array_equal(pt[k], pj[k])


@pytest.mark.parametrize("kernel", ["flash", "xla"])
def test_masked_and_xla_paths_match_jax(kernel):
    jn = JLM(**SIZE, kernel=kernel, seed=7)
    net = TransformerLM(**SIZE, kernel=kernel, device="cpu")
    net.params = params_from_numpy(_jax_tree(jn), device="cpu")
    x = _tokens(2, 32, seed=2)
    mask = np.ones((2, 32), np.float32)
    mask[1, 20:] = 0
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jn.output(x)), **TOL)
    np.testing.assert_allclose(net.output(x, mask=mask).numpy(),
                               np.asarray(jn.output(x, mask=mask)), **TOL)


def test_port_zip_loads_in_jax(jnet, jzip, tmp_path):
    x = _tokens(2, 48, seed=3)
    net = load_model(jzip, device="cpu")
    out = str(tmp_path / "port.zip")
    save_model(net, out)
    back = j_load(out)
    np.testing.assert_allclose(np.asarray(back.output(x)), net.output(x).numpy(), **TOL)
    np.testing.assert_array_equal(np.asarray(back.output(x)), np.asarray(jnet.output(x)))
    # the optimizer state the port read comes back intact, entry by entry
    for a, b in zip(jax.tree_util.tree_leaves(back.opt_state),
                    jax.tree_util.tree_leaves(jnet.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with zipfile.ZipFile(jzip) as zj, zipfile.ZipFile(out) as zp:
        uj, up = (np.load(io.BytesIO(z.read("updater.npz"))) for z in (zj, zp))
        assert sorted(up.files) == sorted(uj.files)
        for name in uj.files:
            np.testing.assert_array_equal(up[name], uj[name])
        assert json.loads(zp.read("configuration.json")) == json.loads(
            zj.read("configuration.json"))


def test_port_built_model_round_trips_through_jax(tmp_path):
    net = TransformerLM(**SIZE, seed=3, device="cpu")
    path = str(tmp_path / "fresh.zip")
    net.save(path)
    jn = j_load(path)
    x = _tokens(1, 64, seed=4)
    np.testing.assert_allclose(np.asarray(jn.output(x)), net.output(x).numpy(), **TOL)


def test_bfloat16_checkpoint_leaves(tmp_path):
    jn = JLM(**SIZE, dtype=("bfloat16", "bfloat16"))
    path = str(tmp_path / "bf16.zip")
    j_save(jn, path)
    with zipfile.ZipFile(path) as zf:
        with np.load(zipfile.Path(zf, "params.npz").open("rb")) as z:
            assert any(k.endswith("#bfloat16") for k in z.files)
    net = load_model(path, device="cpu")
    for pj, pt in zip(jax.tree_util.tree_leaves(jn.params),
                      jax.tree_util.tree_leaves(net.params)):
        assert pt.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            pt.view(torch.int16).numpy().view(np.uint16),
            np.asarray(pj).view(np.uint16))
    out = str(tmp_path / "bf16_port.zip")
    save_model(net, out)
    back = j_load(out)
    for a, b in zip(jax.tree_util.tree_leaves(back.params),
                    jax.tree_util.tree_leaves(jn.params)):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      np.asarray(b).view(np.uint16))


def _rewrite(src, dst, meta_fn=None, entry_fn=None):
    with zipfile.ZipFile(src) as zi, zipfile.ZipFile(dst, "w") as zo:
        for name in zi.namelist():
            data = zi.read(name)
            if name == "meta.json" and meta_fn:
                data = json.dumps(meta_fn(json.loads(data))).encode()
            elif entry_fn:
                data = entry_fn(name, data)
            zo.writestr(name, data)


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_loads_every_format_version(jnet, jzip, tmp_path, version):
    def meta(m):
        m["format_version"] = version
        if version < 4:
            m.pop("integrity")
        return m
    path = str(tmp_path / f"v{version}.zip")
    _rewrite(jzip, path, meta_fn=meta)
    x = _tokens(1, 16, seed=5)
    np.testing.assert_allclose(load_model(path, device="cpu").output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)


def test_corrupt_entry_fails_its_digest(jzip, tmp_path):
    def flip(name, data):
        if name != "params.npz":
            return data
        b = bytearray(data)
        b[len(b) // 2] ^= 0x01
        return bytes(b)
    path = str(tmp_path / "bad.zip")
    _rewrite(jzip, path, entry_fn=flip)
    with pytest.raises(CheckpointIntegrityError, match="params.npz"):
        load_model(path, device="cpu")
    bad_ver = str(tmp_path / "v9.zip")
    _rewrite(jzip, bad_ver, meta_fn=lambda m: {**m, "format_version": 9})
    with pytest.raises(ValueError, match="v9"):
        load_model(bad_ver, device="cpu")


def test_configuration_parses_unchanged(jnet):
    d = jnet.conf.to_dict()
    conf = MultiLayerConfiguration.from_dict(json.loads(json.dumps(d)))
    assert isinstance(conf.layers[1], PositionalEmbedding)
    assert all(isinstance(l, TransformerBlock) for l in conf.layers[2:-1])
    assert conf.to_dict() == d


# -- import hygiene --------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _forbidden(mod: str) -> bool:
    # "deeplearning4j_tpu_torch".startswith("deeplearning4j_tpu"): match
    # the module or its dotted prefix, never the bare prefix
    return any(mod == f or mod.startswith(f + ".") for f in _FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "pre = set(sys.modules)\n"
        "import deeplearning4j_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(set(sys.modules) - pre)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "deeplearning4j_tpu_torch.serving.decode" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_port_imports_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    bad = {f: m for f in files for m in _imports(f) if _forbidden(m)}
    assert bad == {}


# -- entry points never fall back to the CPU unasked --------------------------------


def _entry_points(jzip):
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    def engine():
        net = load_model(jzip, device="cpu")
        DecodeEngine(TransformerDecodeAdapter(net), page_size=8)

    return {
        "TransformerLM": lambda: TransformerLM(**SIZE),
        "MultiLayerNetwork": lambda: MultiLayerNetwork(
            load_model(jzip, device="cpu").conf),
        "load_model": lambda: load_model(jzip),
        "DecodeEngine": engine,
        "params_from_numpy": lambda: params_from_numpy([{"W": np.ones(2)}]),
        "cli_generate": lambda: cli.main(["generate", "--model", jzip,
                                          "--prompt", "hi"]),
    }


@pytest.mark.parametrize("name", ["TransformerLM", "MultiLayerNetwork",
                                  "load_model", "DecodeEngine",
                                  "params_from_numpy", "cli_generate"])
def test_entry_point_without_device_raises_on_a_cpu_only_machine(jzip, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points(jzip)[name]()
