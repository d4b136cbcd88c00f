"""GPU port: the conv kernel lab (scripts/conv_kernel_lab.py in the port,
variants C and D) against the JAX package's scripts/conv_kernel_lab.py,
on the CPU.

The JAX lab's calls take no `interpret` argument, so the test loads the
script with importlib and runs `build_call_c()` / `build_call_d()` with
`pallas_call` replaced by its interpret-mode form; nothing under
scripts/ is edited. The JAX calls get the lab's padded operand
(`_pad_input`), the port's the unpadded tensor. The port's side runs the
kernels' plain versions, which is what the wrappers take for CPU
tensors; the CUDA kernels themselves are held against them on the card
(`cuda` marker, chip_smoke.py).
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vocal_remover_tpu_torch.nn import (
    conv_chw,
    conv_chw_kernel,
    conv_shift_kernel,
    conv_tapdot_kernel,
)
from vocal_remover_tpu_torch.scripts import bench_conv_kernel
from vocal_remover_tpu_torch.scripts import conv_kernel_lab as tlab

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 2e-5  # the same f32 products, summed in another order


@pytest.fixture(scope="module")
def jlab():
    spec = importlib.util.spec_from_file_location(
        "jax_conv_kernel_lab", os.path.join(ROOT, "scripts",
                                            "conv_kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n, cin, cout, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, cin, h, w)) * 0.5).astype(np.float32)
    wk = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wk, b


def _jax_call(jlab, monkeypatch, variant, x, wk, b, act, dtype):
    """The JAX lab's variant in interpret mode -> float32 numpy."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    build, weights = {"C": (jlab.build_call_c, jlab.weights_c),
                      "D": (jlab.build_call_d, jlab.weights_d)}[variant]
    geom = jlab._geometry(x.shape, dtype, th=8)
    out = build()(jlab._pad_input(jnp.asarray(x, dtype), geom),
                  weights(wk, dtype), jnp.asarray(b).reshape(-1, 1), geom,
                  act, dtype)
    return np.asarray(out, np.float32)


def _port_call(variant, x, wk, b, act, dtype):
    call, weights = {"C": (tlab.call_c, tlab.weights_c),
                     "D": (tlab.call_d, tlab.weights_d)}[variant]
    out = call(torch.from_numpy(x).to(dtype), weights(wk, dtype),
               torch.from_numpy(b).reshape(-1, 1), act, dtype)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("cin,cout", [(4, 4), (3, 5)])
def test_weights_equal_the_labs(jlab, cin, cout):
    _, wk, _ = _inputs(1, cin, cout, 4, 4, seed=cin)
    np.testing.assert_array_equal(
        tlab.weights_c(wk, torch.float32).numpy(),
        np.asarray(jlab.weights_c(wk, jnp.float32)))
    np.testing.assert_array_equal(
        tlab.weights_d(wk, torch.float32).numpy(),
        np.asarray(jlab.weights_d(wk, jnp.float32)))
    np.testing.assert_array_equal(
        tlab.weights_c(wk, torch.bfloat16).float().numpy(),
        np.asarray(jlab.weights_c(wk, jnp.bfloat16), np.float32))


@pytest.mark.parametrize("variant", ["C", "D"])
@pytest.mark.parametrize("n,cin,cout,h,w,act", [
    (1, 4, 4, 20, 40, True),    # ragged H (20 rows in tiles of 8)
    (2, 3, 5, 16, 24, True),    # Cin != Cout
    (1, 4, 6, 13, 40, False),   # no activation
    # D's ragged edges, tiny: Cin no multiple of a channel chunk, Cout
    # under one m16 tile, H no multiple of the row tile, W no whole chunk
    (1, 40, 7, 13, 30, True),
    (1, 5, 7, 11, 42, False),
])
def test_f32_matches_the_lab(jlab, monkeypatch, variant, n, cin, cout, h, w,
                             act):
    x, wk, b = _inputs(n, cin, cout, h, w, seed=h)
    ref = _jax_call(jlab, monkeypatch, variant, x, wk, b, act, jnp.float32)
    out = _port_call(variant, x, wk, b, act, torch.float32)
    assert out.shape == ref.shape == (n, cout, h, w)
    np.testing.assert_allclose(out, ref, atol=F32_ATOL)


def _check_bf16(jlab, monkeypatch, variant, x, wk, b):
    """bf16 in and out, compared in float32: against the f32 result with
    the bounds of tests/test_conv_pallas.py::test_bf16_io, and against
    the lab's bf16 output within one bf16 step."""
    full = _port_call(variant, x, wk, b, True, torch.float32)
    ref = _jax_call(jlab, monkeypatch, variant, x, wk, b, True, jnp.bfloat16)
    out = _port_call(variant, x, wk, b, True, torch.bfloat16)
    assert np.abs(out - full).max() < 0.1
    assert np.abs(out - full).mean() < 0.01
    assert np.abs(out - ref).max() <= 2.0 ** -7 * np.abs(full).max()


@pytest.mark.parametrize("variant", ["C", "D"])
def test_bf16_matches_the_lab(jlab, monkeypatch, variant):
    _check_bf16(jlab, monkeypatch, variant, *_inputs(1, 4, 6, 20, 40, seed=11))


@pytest.mark.parametrize("variant", ["C", "D"])
def test_bf16_matches_the_lab_at_ragged_edges(jlab, monkeypatch, variant):
    """D's ragged edges: Cin 40 (no multiple of the 32-channel chunk),
    Cout 7, H 13, W 30."""
    _check_bf16(jlab, monkeypatch, variant, *_inputs(1, 40, 7, 13, 30, seed=12))


@pytest.mark.parametrize("act", ["leaky_relu", "relu", None])
def test_plain_versions_agree(act):
    """A, C and D compute one function: the stride-1 3x3 'SAME' conv."""
    x, wk, b = _inputs(2, 5, 7, 11, 37, seed=4)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    w2, taps, pad = conv_chw.prepare_weights_s1(wk)
    a = conv_chw_kernel.conv_call_plain(
        xt, torch.from_numpy(w2), bt, taps, pad, conv_chw.pad_origin(pad),
        act, torch.float32)
    c = conv_shift_kernel.conv_shift_plain(
        xt, tlab.weights_c(wk, torch.float32), bt, act=act,
        out_dtype=torch.float32)
    d = conv_tapdot_kernel.conv_tapdot_plain(
        xt, tlab.weights_d(wk, torch.float32), bt, act=act,
        out_dtype=torch.float32)
    np.testing.assert_allclose(c.numpy(), a.numpy(), atol=F32_ATOL)
    np.testing.assert_allclose(d.numpy(), a.numpy(), atol=F32_ATOL)


@pytest.mark.parametrize("module,name", [
    (conv_shift_kernel, "conv_shift"), (conv_tapdot_kernel, "conv_tapdot")])
def test_wrappers_check_operands_and_count_no_plain_call(module, name):
    x, wk, b = _inputs(1, 4, 6, 8, 16)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    w2 = tlab.weights_d(wk, torch.float32)
    call = getattr(module, name)
    before = module.launches
    call(xt, w2, bt, act="relu", out_dtype=torch.float32)
    assert module.launches == before
    with pytest.raises(ValueError, match="9 \\* Cin"):
        call(xt, w2[:-1], bt, act="relu", out_dtype=torch.float32)
    with pytest.raises(TypeError):
        call(xt, w2.bfloat16(), bt, act="relu", out_dtype=torch.float32)
    with pytest.raises(ValueError, match="activation"):
        call(xt, w2, bt, act="gelu", out_dtype=torch.float32)


SMALL = ["--device", "cpu", "--len", "2", "--repeat", "1", "--shapes",
         "1,4,16,32", "--dtype", "float32"]


def test_lab_tool_runs_on_the_cpu(capsys):
    rows = tlab.main(SMALL)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "ms/conv" in ln]
    assert [r["variant"] for r in rows] == ["A", "C", "D"]
    assert len(lines) == 3 and all("maxerr" in ln for ln in lines)
    assert all(r["max_err"] < 1e-5 for r in rows)
    # --variants picks, --th is accepted and ignored
    rows = tlab.main(SMALL + ["--variants", "C", "--th", "8"])
    assert [r["variant"] for r in rows] == ["C"]


def test_bench_tool_runs_on_the_cpu(capsys):
    rows = bench_conv_kernel.main(SMALL)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "ms/conv" in ln]
    assert [r["route"] for r in rows] == ["kernel", "lib_nhwc", "lib_nchw",
                                          "lib_taps"]
    assert len(lines) == 4


@pytest.mark.parametrize("tool", [tlab, bench_conv_kernel])
def test_tools_raise_without_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--len", "1", "--repeat", "1", "--shapes", "1,2,4,8"])


def test_lab_check_fails_on_a_wrong_kernel(monkeypatch):
    """The single-layer check against conv2d is a check: a variant that
    computes something else raises."""
    monkeypatch.setattr(
        conv_shift_kernel, "conv_shift",
        lambda x, w2, b, **kw: conv_shift_kernel.conv_shift_plain(
            x, w2, b, **kw) + 0.01)
    with pytest.raises(RuntimeError, match="C output-shift"):
        tlab.main(SMALL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


CARD_TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)]
CARD_KERNELS = {"C": (conv_shift_kernel, "conv_shift", tlab.weights_c),
                "D": (conv_tapdot_kernel, "conv_tapdot", tlab.weights_d)}


def _check_on_card(variant, x, wk, b, dtype, tol):
    """The CUDA kernel against its plain version on the same device
    tensors; bf16 is compared in the working type (one bf16 step at the
    output's magnitude)."""
    module, name, weights = CARD_KERNELS[variant]
    args = (x, weights(wk, dtype).to(x.device),
            torch.from_numpy(b).to(x.device))
    kw = dict(act="leaky_relu", out_dtype=dtype)
    before = module.launches
    out = getattr(module, name)(*args, **kw)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    ref = getattr(module, name + "_plain")(*args, **kw)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_TOLS)
@pytest.mark.parametrize("variant", ["C", "D"])
@pytest.mark.parametrize("n,cin,cout,h,w", [
    (2, 26, 32, 33, 40), (2, 5, 7, 9, 300), (1, 3, 9, 5, 700),
    (1, 16, 24, 20, 64), (2, 32, 32, 64, 256),
    # the lab's two full shapes (scripts/conv_kernel_lab.py defaults)
    (8, 32, 32, 1024, 256), (8, 64, 64, 512, 128),
    # weights too many to stay resident: streamed with the input
    (1, 200, 24, 6, 72),
    # D's ragged edges: Cin 40 / 200 (no multiple of a channel chunk; 200
    # streams its weights), Cout 7 (under one m16 tile), H 13 / 11 (no
    # multiple of the 8-row tile), W 302 (no whole 4-column staging load:
    # plain loads) and 300 (no whole 16-byte chunk)
    (1, 40, 7, 13, 302), (2, 200, 7, 11, 300),
    # the longest sums: a float32 error that grows with Cin shows here
    (1, 512, 32, 16, 64),
])
def test_kernels_match_plain_on_card(cuda_device, dtype, tol, variant, n, cin,
                                     cout, h, w):
    """The CUDA kernels against their plain versions on the same device
    tensors."""
    x, wk, b = _inputs(n, cin, cout, h, w, seed=5)
    _check_on_card(variant, torch.from_numpy(x).to(cuda_device, dtype), wk, b,
                   dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_TOLS)
@pytest.mark.parametrize("variant", ["C", "D"])
def test_kernels_take_an_unaligned_input_on_card(cuda_device, dtype, tol,
                                                 variant):
    """An input that is a contiguous view one element into its storage
    (not 16-byte aligned) takes the kernels' plain-load staging."""
    x, wk, b = _inputs(2, 24, 20, 19, 64, seed=6)
    flat = torch.zeros(x.size + 1, dtype=dtype, device=cuda_device)
    xt = flat[1:].view(x.shape)
    xt.copy_(torch.from_numpy(x))
    assert xt.is_contiguous() and xt.data_ptr() % 16 != 0
    _check_on_card(variant, xt, wk, b, dtype, tol)
