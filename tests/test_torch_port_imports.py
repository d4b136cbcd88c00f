"""GPU port: no JAX anywhere in the port, and its own audio I/O vs the
JAX package's."""

import ast
import os

import numpy as np
import pytest
import torch

from vocal_remover_tpu import native
from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu_torch.utils import audio as taudio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    pkg = os.path.join(ROOT, "vocal_remover_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


# what no file of the port may import: JAX, the JAX package, and the
# libraries only the JAX package uses
REFUSED = ("jax", "jaxlib", "vocal_remover_tpu", "flax", "msgpack", "optax")


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in REFUSED, (
                f"{os.path.relpath(path, ROOT)} imports {mod}")


@pytest.mark.parametrize("name", ["__init__", "distributed", "mesh",
                                  "policy", "collectives"])
def test_parallel_files_import_no_jax(name):
    """The parallel package is among the parsed files and imports torch
    (torch.distributed), never JAX, the JAX package, flax, msgpack or
    optax."""
    path = os.path.join(ROOT, "vocal_remover_tpu_torch", "parallel",
                        f"{name}.py")
    assert path in _port_files()
    mods = set(_imported_modules(path))
    assert not {m.split(".")[0] for m in mods} & set(REFUSED), mods
    if name != "__init__":
        assert any(m.split(".")[0] == "torch" for m in mods), mods


@pytest.mark.parametrize("module,source", [
    ("nn/lstm_kernel.py", "csrc/lstm_recurrence.cu"),
    ("nn/flat_conv_kernel.py", "csrc/flat_conv.cu"),
    ("nn/conv_chw_kernel.py", "csrc/conv_chw.cu"),
    ("nn/conv_shift_kernel.py", "csrc/conv_shift.cu"),
    ("nn/conv_tapdot_kernel.py", "csrc/conv_tapdot.cu"),
])
def test_kernel_wrappers_have_no_fallback(module, source):
    """A wrapper launches its kernel or raises: no `try` around the
    launch, no conv / compile call to fall back on, no matrix product
    outside its `*_plain` twin, a `launches` count, and its CUDA source
    beside it."""
    pkg = os.path.join(ROOT, "vocal_remover_tpu_torch")
    assert os.path.exists(os.path.join(pkg, source))
    path = os.path.join(pkg, module)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"conv2d", "compile", "conv_general_dilated"}
    plain = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name.endswith("_plain")]
    assert plain, "no plain twin"
    inside = {id(n) for f in plain for n in ast.walk(f)}
    products = [n for n in ast.walk(tree) if id(n) not in inside and (
        (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
         and n.func.attr in {"matmul", "einsum", "mm", "bmm"})
        or (isinstance(n, ast.BinOp) and isinstance(n.op, ast.MatMult)))]
    assert not products, f"matrix product outside the plain twin: {products}"
    assert any(isinstance(n, ast.Assign) and n.targets[0].id == "launches"
               for n in tree.body if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Name))


def test_pcm16_encode_matches_jax(rng):
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4000),
                        np.arange(-4, 5) / 65536.0,  # ties round to even
                        [1.0, -1.0, 1 - 1 / 65536]]).astype(np.float32)
    ref = native.pcm16_encode(x)
    if ref is None:  # the JAX package's numpy fallback
        ref = np.round(np.clip(x, -1.0, 1.0 - 1.0 / 32768.0)
                       * 32768.0).astype(np.int16)
    np.testing.assert_array_equal(taudio.pcm16_encode(x), ref)


@pytest.mark.parametrize("channels", [2, 1])
def test_wav_round_trip_matches_jax(rng, tmp_path, channels):
    wave = (0.5 * rng.standard_normal((channels, 3000))).astype(np.float32)
    if channels == 1:
        wave = wave[0]
    ours, theirs = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    taudio.write_wav(ours, wave, 8000)
    jaudio.write_wav(theirs, wave, 8000)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, sr = taudio.load(ours, sr=None)
    want, _ = jaudio.load(theirs, sr=None)
    assert sr == 8000 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_resamples_like_jax(rng, tmp_path):
    path = str(tmp_path / "song.wav")
    jaudio.write_wav(path, (0.3 * rng.standard_normal((2, 2205))
                            ).astype(np.float32), 22050)
    got, sr = taudio.load(path, sr=8000)
    want, _ = jaudio.load(path, sr=8000)
    assert sr == 8000 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_refuses_compressed_formats(tmp_path, monkeypatch):
    """A compressed file that its native decoder rejects is refused as
    the JAX package refuses it: ffmpeg would be its last resort, and it
    is not on PATH."""
    path = str(tmp_path / "song.flac")
    with open(path, "wb") as f:
        f.write(b"RIFFnotflac" * 8)
    monkeypatch.setattr(taudio, "_FFMPEG", None)
    monkeypatch.setattr(jaudio, "_FFMPEG", None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        taudio.load(path)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        jaudio.load(path)


def test_native_decoders_are_the_ports_own():
    """The decoders build from the port's own copies: every source and
    header the build reads lies in vocal_remover_tpu_torch/native, every
    quoted #include names a file there, and no source of the port names
    a path into the JAX package's native/."""
    import re

    from vocal_remover_tpu_torch.native import build

    own = os.path.join(ROOT, "vocal_remover_tpu_torch", "native")
    assert os.path.samefile(build.SRC_DIR, own)
    assert build.BUILD_DIR.parent.name == "build" and os.path.samefile(
        build.BUILD_DIR.parent.parent, ROOT)
    for name in build.SOURCES + build.HEADERS:
        assert os.path.exists(os.path.join(own, name)), name
    for name in os.listdir(own):
        path = os.path.join(own, name)
        if name.endswith((".c", ".h")):
            with open(path) as f:
                for inc in re.findall(r'#include\s+"([^"]+)"', f.read()):
                    assert os.path.dirname(inc) == "" and os.path.exists(
                        os.path.join(own, inc)), f"{name} includes {inc}"
    jax_native = re.compile(r"vocal_remover_tpu[/.]native")
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert not jax_native.search(node.value), (
                    f"{os.path.relpath(path, ROOT)} points into the JAX "
                    f"package's native/: {node.value!r}")
