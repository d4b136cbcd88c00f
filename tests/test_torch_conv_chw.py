"""GPU port: the channel-major fused conv (nn/conv_chw.py, variant A)
against the JAX package's nn/conv_pallas.py, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_conv_pallas.py does; the port's side runs the kernel's plain
version (`conv_call_plain`), which is what the wrapper takes for CPU
tensors. Shapes the TPU kernel refuses (W no multiple of 128, 1x1, 5x5)
are held against the XLA convolution. The CUDA kernel itself is held
against the plain version on the card (`cuda` marker, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.nn import conv_pallas as jcp
from vocal_remover_tpu_torch.nn import conv_chw as tcp
from vocal_remover_tpu_torch.nn import conv_chw_kernel

torch.set_num_threads(1)

F32_ATOL = 2e-5  # the same f32 products, summed in another order


def _inputs(cin, cout, h, w, k=3, n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cin, h, w)).astype(np.float32)
    wk = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, wk, b


def _xla_conv(x, wk, b, stride, padding, act):
    """The XLA convolution in NCHW + bias + activation, float32."""
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wk), (stride, stride), padding,
        dimension_numbers=("NCHW", "HWIO", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    y = y + jnp.asarray(b)[None, :, None, None]
    if act == "relu":
        y = jnp.maximum(y, 0.0)
    elif act == "leaky_relu":
        y = jnp.where(y >= 0, y, 0.01 * y)
    return np.asarray(y)


@pytest.mark.parametrize("k,cin,cout", [(3, 5, 7), (1, 6, 4), (5, 3, 8),
                                        (2, 4, 4)])
def test_prepare_weights_s1_equals_jax(k, cin, cout):
    _, wk, _ = _inputs(cin, cout, 4, 4, k=k, seed=k)
    w2, taps, pad = tcp.prepare_weights_s1(wk)
    jw2, jtaps, jpad = jcp.prepare_weights_s1(wk)
    np.testing.assert_array_equal(w2, np.asarray(jw2))
    assert taps == jtaps and pad == jpad
    # a torch tensor goes in as well
    w2t, taps_t, pad_t = tcp.prepare_weights_s1(torch.from_numpy(wk))
    np.testing.assert_array_equal(w2t, w2)
    assert (taps_t, pad_t) == (taps, pad)


@pytest.mark.parametrize("cin,cout", [(8, 16), (3, 5)])
def test_prepare_weights_s2_equals_jax(cin, cout):
    _, wk, _ = _inputs(cin, cout, 4, 4, seed=cin)
    w2, taps, pad = tcp.prepare_weights_s2(wk)
    jw2, jtaps, jpad = jcp.prepare_weights_s2(wk)
    np.testing.assert_array_equal(w2, np.asarray(jw2))
    assert taps == jtaps and pad == jpad == (1, 1)


def test_prepare_weights_s2_refuses_other_kernels():
    with pytest.raises(ValueError, match="3x3"):
        tcp.prepare_weights_s2(np.zeros((5, 5, 2, 2), np.float32))


@pytest.mark.parametrize("shape", [(2, 3, 8, 12), (1, 8, 40, 128)])
def test_space_to_depth_equals_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tcp.space_to_depth(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcp.space_to_depth(jnp.asarray(x))))


@pytest.mark.parametrize("cin,cout,h,w", [
    (2, 8, 40, 128),
    (8, 16, 33, 128),   # ragged H
    (26, 32, 64, 256),  # stage-3 enc1 shape class
])
@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_stride1_matches_jax(cin, cout, h, w, act):
    x, wk, b = _inputs(cin, cout, h, w, seed=cin * 100 + cout)
    jw2, jtaps, jpad = jcp.prepare_weights_s1(wk)
    ref = np.asarray(jcp.fused_conv_chw(jnp.asarray(x), jw2, b, jtaps, jpad,
                                        act=act, interpret=True))
    w2, taps, pad = tcp.prepare_weights_s1(wk)
    out = tcp.fused_conv_chw(torch.from_numpy(x), w2, b, taps, pad, act=act)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)
    np.testing.assert_allclose(
        out.numpy(), _xla_conv(x, wk, b, 1, "SAME", act), atol=F32_ATOL)


@pytest.mark.parametrize("cin,cout,h,w", [
    (8, 16, 40, 128),
    (32, 64, 64, 256),
])
def test_stride2_s2d_matches_jax(cin, cout, h, w):
    x, wk, b = _inputs(cin, cout, h, w, seed=3)
    jw2, jtaps, jpad = jcp.prepare_weights_s2(wk)
    ref = np.asarray(jcp.fused_conv_chw(
        jcp.space_to_depth(jnp.asarray(x)), jw2, b, jtaps, jpad,
        act="leaky_relu", interpret=True))
    w2, taps, pad = tcp.prepare_weights_s2(wk)
    out = tcp.fused_conv_chw(tcp.space_to_depth(torch.from_numpy(x)), w2, b,
                             taps, pad, act="leaky_relu")
    assert out.shape == ref.shape == (2, cout, h // 2, w // 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)
    np.testing.assert_allclose(
        out.numpy(),
        _xla_conv(x, wk, b, 2, [(1, 1), (1, 1)], "leaky_relu"),
        atol=F32_ATOL)


def test_bf16_io_matches_jax():
    """bf16 in and out, compared in float32 with the bounds of
    tests/test_conv_pallas.py::test_bf16_io against the f32 conv, and
    against the JAX kernel's bf16 output within one bf16 step."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 32, 128)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, 8, 8)) * 0.2).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    ref = _xla_conv(x, wk, b, 1, "SAME", "relu")
    jw2, jtaps, jpad = jcp.prepare_weights_s1(wk)
    jout = np.asarray(jcp.fused_conv_chw(
        jnp.asarray(x, jnp.bfloat16), jw2, b, jtaps, jpad, act="relu",
        interpret=True)).astype(np.float32)
    w2, taps, pad = tcp.prepare_weights_s1(wk)
    out = tcp.fused_conv_chw(torch.from_numpy(x).bfloat16(), w2, b, taps, pad,
                             act="relu")
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert np.abs(out - ref).max() < 0.1
    assert np.abs(out - ref).mean() < 0.01
    # both round the same f32 sum (reached in another order) to bf16
    assert np.abs(out - jout).max() <= 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("k,padding,cin,cout,h,w,act", [
    (3, "SAME", 4, 6, 21, 40, "leaky_relu"),   # W no multiple of 128
    (3, "SAME", 3, 5, 9, 40, None),            # no activation
    (1, "VALID", 6, 4, 10, 40, "relu"),        # 1x1: no taps beyond the pixel
    # 5x5: as in the JAX package, a pad other than (2, 2) lies on the top
    # and left only
    (5, [(4, 0), (4, 0)], 3, 4, 12, 24, "relu"),
])
def test_shapes_the_tpu_kernel_refuses_match_xla(k, padding, cin, cout, h, w,
                                                 act):
    x, wk, b = _inputs(cin, cout, h, w, k=k, seed=k + w)
    w2, taps, pad = tcp.prepare_weights_s1(wk)
    out = tcp.fused_conv_chw(torch.from_numpy(x), w2, b, taps, pad, act=act)
    ref = _xla_conv(x, wk, b, 1, padding, act)
    assert out.shape == ref.shape == (2, cout, h, w)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)


@pytest.mark.parametrize("k,cin,cout,h,w", [
    (7, 3, 4, 12, 24),  # 49 taps, origin (6, 6)
    (9, 2, 3, 11, 20),  # 81 taps, reach 8
])
def test_long_tap_tables_match_jax(k, cin, cout, h, w):
    """Tables past 32 taps run as the JAX kernel runs them (no limit on
    the table's length)."""
    x, wk, b = _inputs(cin, cout, h, w, k=k, n=1, seed=k)
    jw2, jtaps, jpad = jcp.prepare_weights_s1(wk)
    ref = np.asarray(jcp.fused_conv_chw(jnp.asarray(x), jw2, b, jtaps, jpad,
                                        act="relu", interpret=True))
    w2, taps, pad = tcp.prepare_weights_s1(wk)
    assert len(taps) == k * k and tcp.pad_origin(pad) == (k - 1, k - 1)
    out = tcp.fused_conv_chw(torch.from_numpy(x), w2, b, taps, pad, act="relu")
    assert out.shape == ref.shape == (1, cout, h, w)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)


def test_stride2_ragged_channel_block_matches_jax():
    """Cin 5: the space-to-depth tensor holds four blocks of 5 channels,
    so a chunk of any block must not read the next block's channels."""
    x, wk, b = _inputs(5, 7, 18, 40, seed=11)
    jw2, jtaps, jpad = jcp.prepare_weights_s2(wk)
    ref = np.asarray(jcp.fused_conv_chw(
        jcp.space_to_depth(jnp.asarray(x)), jw2, b, jtaps, jpad,
        act="leaky_relu", interpret=True))
    w2, taps, pad = tcp.prepare_weights_s2(wk)
    xin = tcp.space_to_depth(torch.from_numpy(x))
    assert xin.shape[1] == 20 and w2.shape[0] == 9 * 5
    out = tcp.fused_conv_chw(xin, w2, b, taps, pad, act="leaky_relu")
    assert out.shape == ref.shape == (2, 7, 9, 20)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)


def _tables():
    """(label, taps, pad) of the tables the kernel is given: stride 1 at
    1x1 to 11x11, the stride-2 remap, and a table with a repeated tap."""
    out = []
    for k in (1, 3, 5, 7, 11):
        _, taps, pad = tcp.prepare_weights_s1(np.zeros((k, k, 1, 1)))
        out.append((f"{k}x{k}", taps, pad))
    _, taps, pad = tcp.prepare_weights_s2(np.zeros((3, 3, 1, 1)))
    out.append(("stride 2", taps, pad))
    out.append(("repeated", ((0, 1, 1), (0, 0, 2), (0, 1, 1)), (2, 2)))
    return out


@pytest.mark.parametrize("label,taps,pad", _tables(),
                         ids=[t[0] for t in _tables()])
def test_tap_groups_cover_the_table(label, taps, pad):
    """Every tap lies in exactly one group, at its slot, inside the
    group's rows and columns and the kernel's GROUP_ROWS x GROUP_COLS;
    each group's weight slabs follow the previous group's; the records
    give the same conv as the table (each slot's product summed at the
    group's offset)."""
    origin = tcp.pad_origin(pad)
    groups = conv_chw_kernel.tap_groups(taps, origin)
    rows, cols = conv_chw_kernel.GROUP_ROWS, conv_chw_kernel.GROUP_COLS
    assert groups.dtype == np.int32
    assert groups.shape[1] == conv_chw_kernel.GROUP_INTS
    seen, slab = [], 0
    for cblk, row0, col0, gh, gw, slab0, *rest in groups.tolist():
        assert 1 <= gh <= rows and 1 <= gw <= cols
        assert slab0 == slab
        slab += gh * gw
        slots = rest[:rows * cols]
        assert not any(rest[rows * cols:])
        for s, t in enumerate(slots):
            if t < 0:
                continue
            sy, sx = divmod(s, cols)
            assert sy < gh and sx < gw
            assert taps[t] == (cblk, row0 + origin[0] + sy,
                               col0 + origin[1] + sx)
            seen.append(t)
    assert sorted(seen) == list(range(len(taps)))
    # the records' conv against the table's, on 2 channel blocks of 3
    rng = np.random.default_rng(len(taps))
    n_blk = 1 + max(t[0] for t in taps)
    x = torch.from_numpy(rng.standard_normal((1, 3 * n_blk, 9, 13),
                                             dtype=np.float32))
    w2 = torch.from_numpy(rng.standard_normal((3 * len(taps), 4),
                                              dtype=np.float32))
    b = torch.zeros(4)
    ref = conv_chw_kernel.conv_call_plain(x, w2, b, taps, pad, origin, None,
                                          torch.float32)
    m = 12  # a margin past every reach
    xp = torch.nn.functional.pad(x, (m, m, m, m))
    got = torch.zeros_like(ref)
    for cblk, row0, col0, _, _, _, *slots in groups.tolist():
        for s, t in enumerate(slots[:rows * cols]):
            if t >= 0:
                sy, sx = divmod(s, cols)
                r, c = m + row0 + sy, m + col0 + sx
                xs = xp[:, 3 * cblk:3 * cblk + 3, r:r + 9, c:c + 13]
                got += torch.einsum("nkhw,ko->nohw", xs, w2[3 * t:3 * t + 3])
    torch.testing.assert_close(got, ref, atol=F32_ATOL, rtol=0)


def test_out_dtype_f32_from_bf16_input():
    x, wk, b = _inputs(4, 6, 12, 40, seed=9)
    w2, taps, pad = tcp.prepare_weights_s1(wk)
    xb = torch.from_numpy(x).bfloat16()
    out = tcp.fused_conv_chw(xb, w2, b, taps, pad, act="leaky_relu",
                             out_dtype=torch.float32)
    assert out.dtype == torch.float32
    # the conv of the bf16-rounded operands, exactly accumulated in f32
    ref = _xla_conv(xb.float().numpy(),
                    torch.from_numpy(wk).bfloat16().float().numpy(), b, 1,
                    "SAME", "leaky_relu")
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)


@pytest.mark.parametrize("ksize,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_folded_block_through_fused_conv(ksize, stride, pad):
    """A BN-folded Conv2DBNActiv of the serving model, carried across by
    `prepare_folded_conv`, gives the block's own output."""
    from vocal_remover_tpu_torch.models import serving
    from vocal_remover_tpu_torch.nn import layers

    block = layers.Conv2DBNActiv(6, 10, ksize, stride, pad,
                                 activ="leaky_relu")
    layers.reset_parameters(block, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(8)
    bn = block.conv[1]
    with torch.no_grad():
        for v, lo, hi in ((bn.weight, 0.5, 1.5), (bn.bias, -0.3, 0.3),
                          (bn.running_mean, -0.3, 0.3),
                          (bn.running_var, 0.5, 1.5)):
            v.copy_(torch.from_numpy(
                rng.uniform(lo, hi, v.shape).astype(np.float32)))
    block.eval()
    x = torch.from_numpy(rng.standard_normal((2, 6, 12, 20),
                                             dtype=np.float32))
    with torch.no_grad():
        ref = block(x)
    folded = serving.fold_batch_norms(block)
    w2, b, taps, pad_hw, act = tcp.prepare_folded_conv(folded)
    assert act == "leaky_relu"
    xin = tcp.space_to_depth(x) if stride == 2 else x
    out = tcp.fused_conv_chw(xin, w2, b, taps, pad_hw, act=act)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_ATOL)
    dilated = layers.Conv2DBNActiv(4, 4, 3, 1, 4, 4)
    with pytest.raises(ValueError, match="dilation"):
        tcp.prepare_folded_conv(dilated)


def _call_args():
    x, wk, b = _inputs(4, 6, 8, 16, seed=2)
    w2, taps, pad = tcp.prepare_weights_s1(wk)
    return [torch.from_numpy(x), torch.from_numpy(w2), torch.from_numpy(b),
            taps, pad, tcp.pad_origin(pad), "relu", torch.float32]


@pytest.mark.parametrize("change,error", [
    (lambda a: a.__setitem__(6, "gelu"), ValueError),
    (lambda a: a.__setitem__(1, a[1].bfloat16()), TypeError),
    (lambda a: a.__setitem__(2, a[2].double()), TypeError),
    (lambda a: a.__setitem__(7, torch.float16), TypeError),
    (lambda a: a.__setitem__(1, a[1][:-1]), ValueError),
    (lambda a: a.__setitem__(2, a[2][:-1]), ValueError),
    (lambda a: a.__setitem__(3, ((0, 3, 0),) + a[3][1:]), ValueError),
    (lambda a: a.__setitem__(3, ((1, 0, 0),) + a[3][1:]), ValueError),
    (lambda a: a.__setitem__(3, ()), ValueError),
    (lambda a: a.__setitem__(5, (3, 1)), ValueError),
])
def test_conv_call_refuses_bad_operands(change, error):
    args = _call_args()
    change(args)
    with pytest.raises(error):
        conv_chw_kernel.conv_call(*args)


def test_plain_calls_are_not_counted():
    before = conv_chw_kernel.launches
    conv_chw_kernel.conv_call(*_call_args())
    assert conv_chw_kernel.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_conv_call_rejects_non_contiguous_on_card(cuda_device):
    args = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
            for a in _call_args()]
    args[0] = args[0].transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        conv_chw_kernel.conv_call(*args)


CARD_TOLS = [(torch.float32, torch.float32, 1e-4),
             (torch.bfloat16, torch.bfloat16, 2.0 ** -6),
             # bf16 in, f32 out: the exact f32 sum of the same products
             (torch.bfloat16, torch.float32, 1e-4)]


def _check_on_card(x, wk, b, stride, out_dtype, tol, unaligned=False):
    """The CUDA kernel against its plain version on the same device
    tensors; bf16 out is compared in the working type (one bf16 step at
    the output's magnitude). `unaligned`: the kernel's input is a
    contiguous view one element into its storage (not 16-byte aligned)."""
    if stride == 2:
        x = tcp.space_to_depth(x).contiguous()
        w2, taps, pad = tcp.prepare_weights_s2(wk)
    else:
        w2, taps, pad = tcp.prepare_weights_s1(wk)
    if unaligned:
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
        x = flat[1:].view(x.shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    args = (x, torch.from_numpy(w2).to(x.device, x.dtype),
            torch.from_numpy(b).to(x.device), taps, pad,
            tcp.pad_origin(pad), "leaky_relu", out_dtype)
    before = conv_chw_kernel.launches
    out = conv_chw_kernel.conv_call(*args)
    torch.cuda.synchronize()
    assert conv_chw_kernel.launches == before + 1
    ref = conv_chw_kernel.conv_call_plain(*args)
    assert out.dtype == ref.dtype == out_dtype
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype,tol", CARD_TOLS)
@pytest.mark.parametrize("cin,cout,h,w,k,stride", [
    (26, 32, 33, 40, 3, 1), (32, 32, 64, 256, 3, 1), (8, 16, 40, 128, 3, 2),
    (16, 24, 20, 64, 1, 1), (6, 10, 17, 50, 5, 1), (5, 7, 9, 300, 3, 1),
    # reach past an 8-column halo: 7x7 (six tap groups) and 11x11 (twelve)
    (6, 10, 17, 50, 7, 1), (3, 5, 21, 70, 11, 1),
    # stride 2 with ragged channel blocks: four blocks of 5
    (5, 7, 18, 40, 3, 2),
    # Cin no multiple of a channel chunk (40, 200: weights streamed) or
    # 512 (the longest sums), Cout 7 (under one m16 tile) and 32
    (40, 7, 13, 70, 3, 1), (40, 32, 13, 70, 3, 1), (200, 7, 11, 70, 3, 1),
    (200, 32, 11, 70, 3, 1), (512, 7, 16, 64, 3, 1), (512, 32, 16, 64, 3, 1),
    # W no whole 16-byte chunk of bf16 (plain loads and stores)
    (24, 20, 13, 302, 3, 1),
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, out_dtype, tol, cin,
                                      cout, h, w, k, stride):
    x, wk, b = _inputs(cin, cout, h, w, k=k, seed=5)
    _check_on_card(torch.from_numpy(x).to(cuda_device, dtype), wk, b, stride,
                   out_dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype,tol", CARD_TOLS)
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (7, 1)])
def test_kernel_takes_an_unaligned_input_on_card(cuda_device, dtype,
                                                 out_dtype, tol, k, stride):
    """An input that is not 16-byte aligned takes the kernel's plain-load
    staging."""
    x, wk, b = _inputs(24, 20, 20, 64, k=k, seed=6)
    _check_on_card(torch.from_numpy(x).to(cuda_device, dtype), wk, b, stride,
                   out_dtype, tol, unaligned=True)
