"""GPU port: the flat pixel-packed conv (nn/conv_pack.py,
nn/flat_conv_kernel.py) against the JAX package's, whose Pallas kernel
runs in interpret mode on the CPU. On the CPU the port's wrapper takes
`flat_conv_core_plain`; the CUDA kernel itself is held against that plain
version on the card (`cuda` marker, chip_smoke.py).

Shape classes are those of tests/test_conv_pack.py with H cut (interpret
mode is slow): every pack factor is kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.nn import conv_pack as jcp
from vocal_remover_tpu_torch.nn import conv_pack as tcp
from vocal_remover_tpu_torch.nn import flat_conv_kernel

torch.set_num_threads(1)

# (cin, cout, h, w): pack 4, 2, 8, 1 (block == pixel), 16
STRIDE1 = [(32, 64, 8, 256), (64, 64, 8, 256), (16, 32, 8, 512),
           (128, 128, 8, 64), (8, 8, 8, 1024)]
# p_in 4 -> p_out 2, 8 -> 4, 2 -> 1
STRIDE2 = [(32, 64, 8, 256), (16, 32, 8, 256), (64, 128, 8, 256)]


def _inputs(c, cout, h, w, k, seed, n=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wk = (rng.standard_normal((k, k, c, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, wk, b


@pytest.mark.parametrize("stride,k,c,cout,p_out", [
    (1, 3, 32, 64, 4), (1, 3, 64, 64, 2), (1, 3, 16, 32, 8),
    (1, 3, 128, 128, 1), (1, 3, 8, 8, 16),
    (2, 3, 32, 64, 2), (2, 3, 16, 32, 4), (2, 3, 64, 128, 1),
    (1, 1, 32, 48, 4),
])
def test_build_flat_layer_equals_jax(stride, k, c, cout, p_out):
    """Exact: both are the same numpy arithmetic."""
    _, wk, b = _inputs(c, cout, 1, 1, k, seed=c + cout)
    ours = tcp.build_flat_layer(wk, b, p_out, stride, act="relu")
    theirs = jcp.build_flat_layer(wk, b, p_out, stride, act="relu")
    assert set(ours) == set(theirs)
    for key in theirs:
        if key in ("wst", "bias"):
            np.testing.assert_array_equal(ours[key], theirs[key])
        else:
            assert ours[key] == theirs[key], key
    assert tcp.flat_geometry(k, stride) == jcp.flat_geometry(k, stride)


@pytest.mark.parametrize("c,cout,h,w", STRIDE1)
@pytest.mark.parametrize("act", ["leaky_relu", None])
def test_stride1_3x3_matches_jax(c, cout, h, w, act):
    """atol 3e-5, the JAX test's own: same f32 products, another
    summation order."""
    x, wk, b = _inputs(c, cout, h, w, 3, seed=c + cout)
    ref = np.asarray(jcp.flat_conv(jnp.asarray(x), wk, b, act=act,
                                   interpret=True))
    out = tcp.flat_conv(torch.from_numpy(x), wk, b, act=act)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5)


@pytest.mark.parametrize("c,cout,h,w", STRIDE2)
def test_stride2_matches_jax(c, cout, h, w):
    x, wk, b = _inputs(c, cout, h, w, 3, seed=7)
    ref = np.asarray(jcp.flat_conv(jnp.asarray(x), wk, b, stride=2,
                                   act="leaky_relu", interpret=True))
    out = tcp.flat_conv(torch.from_numpy(x), wk, b, stride=2,
                        act="leaky_relu")
    assert out.shape == ref.shape == (2, h // 2, w // 2, cout)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5)


def test_1x1_matches_jax():
    x, wk, b = _inputs(32, 48, 6, 256, 1, seed=9)
    ref = np.asarray(jcp.flat_conv(jnp.asarray(x), wk, b, act="relu",
                                   interpret=True))
    out = tcp.flat_conv(torch.from_numpy(x), wk, b, act="relu")
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5)


def test_flat_chain_encoder_levels():
    """flat_layer_apply flat to flat like the encoder stack: s1 -> s2 ->
    s1, against the same chain in the JAX package, layer by layer (atol
    3e-5) and at the end (atol 1e-4, the JAX test's own for a chain)."""
    rng = np.random.default_rng(13)
    n, h, w, c = 2, 8, 256, 32
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    specs = [(c, c, 1, 0.2), (c, 2 * c, 2, 0.2), (2 * c, 2 * c, 1, 0.1)]
    p1, wb = 128 // c, w // (128 // c)
    jf = jcp.to_flat(jnp.asarray(x), p1)
    tf = tcp.to_flat(torch.from_numpy(x), p1)
    rows, p = h, p1
    for cin, cout, stride, scale in specs:
        wk = (rng.standard_normal((3, 3, cin, cout)) * scale).astype(
            np.float32)
        b = rng.standard_normal(cout).astype(np.float32)
        p //= stride
        jf = jcp.flat_layer_apply(jcp.build_flat_layer(wk, b, p, stride),
                                  jf, rows, wb, interpret=True)
        tf = tcp.flat_layer_apply(tcp.build_flat_layer(wk, b, p, stride),
                                  tf, rows, wb)
        rows //= stride
        assert tuple(tf.shape) == jf.shape == (n, rows * wb, p * cout)
    out = tcp.from_flat(tf, h // 2, w // 2, 2 * c).numpy()
    ref = np.asarray(jcp.from_flat(jf, h // 2, w // 2, 2 * c))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_bf16_io():
    """bf16 in and out, compared in float32: against the f32 conv with
    the JAX test's own bounds, and against the JAX kernel's bf16 output
    within one bf16 step of the largest value (both round the same f32
    sum, summed in another order)."""
    x, wk, b = _inputs(32, 32, 8, 256, 3, seed=11, n=1)
    ref32 = tcp.flat_conv(torch.from_numpy(x), wk, b,
                          act="leaky_relu").numpy()
    jout = np.asarray(jcp.flat_conv(jnp.asarray(x, jnp.bfloat16), wk, b,
                                    act="leaky_relu", interpret=True)
                      ).astype(np.float32)
    out = tcp.flat_conv(torch.from_numpy(x).bfloat16(), wk, b,
                        act="leaky_relu")
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert np.abs(out - ref32).max() < 0.1
    assert np.abs(out - ref32).mean() < 0.01
    assert np.abs(out - jout).max() <= 2.0 ** -7 * np.abs(jout).max()
    # f32 output from bf16 operands is the unrounded sum
    out32 = tcp.flat_conv(torch.from_numpy(x).bfloat16(), wk, b,
                          act="leaky_relu", out_dtype=torch.float32)
    assert out32.dtype == torch.float32
    assert np.abs(out32.numpy() - ref32).max() < 0.1


@pytest.mark.parametrize("x_shape,w_shape,stride,dilation", [
    ((1, 8, 256, 32), (3, 3, 32, 64), 1, 2),     # dilation
    ((1, 8, 250, 32), (3, 3, 32, 64), 1, 1),     # ragged width
    ((1, 9, 256, 32), (3, 3, 32, 64), 2, 1),     # odd H at stride 2
    ((1, 8, 256, 128), (3, 3, 128, 64), 1, 1),   # p_out * cout < 128
    ((1, 8, 256, 32), (3, 3, 32, 64), 1, 1),     # supported
    ((1, 8, 256, 32), (3, 3, 32, 64), 2, 1),     # supported
    ((1, 8, 64, 32), (3, 3, 32, 64), 1, 1),      # wb = 16: supported
    ((1, 8, 16, 32), (3, 3, 32, 64), 1, 1),      # wb = 4: the sublane rule
    ((1, 8, 256, 32), (5, 5, 32, 64), 1, 1),     # 5x5
])
def test_flat_conv_supported_answers_as_jax(x_shape, w_shape, stride,
                                            dilation):
    assert tcp.flat_conv_supported(x_shape, w_shape, stride, dilation) == \
        jcp.flat_conv_supported(x_shape, w_shape, stride, dilation)


def test_flat_conv_rejects_unsupported_shapes():
    x = torch.zeros(1, 8, 250, 32)
    with pytest.raises(ValueError, match="does not take"):
        tcp.flat_conv(x, np.zeros((3, 3, 32, 64), np.float32))


def _core_args(dtype=torch.float32, n=1, h=4, wb=8, l_in=16, nl=16,
               stride=1):
    rowtaps, s_list = tcp.flat_geometry(3, stride)
    return dict(
        xf=torch.zeros(n, stride * h * wb, l_in, dtype=dtype),
        wst=torch.zeros(3, l_in, len(s_list) * nl, dtype=dtype),
        bias=torch.zeros(nl), wb=wb, h_out=h, rowtaps=rowtaps,
        s_list=s_list, act="relu", out_dtype=dtype)


@pytest.mark.parametrize("change,error", [
    (dict(xf=torch.zeros(1, 32, 16, dtype=torch.float64)), TypeError),
    (dict(wst=torch.zeros(3, 16, 48, dtype=torch.bfloat16)), TypeError),
    (dict(bias=torch.zeros(16, dtype=torch.bfloat16)), TypeError),
    (dict(out_dtype=torch.float16), TypeError),
    (dict(xf=torch.zeros(1, 30, 16)), ValueError),       # rows != h * wb
    (dict(wst=torch.zeros(3, 12, 48)), ValueError),      # L mismatch
    (dict(wst=torch.zeros(2, 16, 48)), ValueError),      # tap count
    (dict(bias=torch.zeros(12)), ValueError),            # lanes
    (dict(s_list=(0, 1)), ValueError),                   # not a geometry
    (dict(s_list=(-1, 0)), ValueError),                  # s2 shifts, s1 taps
    (dict(rowtaps=((None, 0), (None, 2), (None, 1))), ValueError),
    (dict(act="gelu"), ValueError),
    (dict(xf=torch.zeros(32, 16)), ValueError),          # rank
])
def test_core_rejects_bad_operands(change, error):
    """The wrapper validates before it picks a path, so the CPU sees the
    same refusals as the card."""
    args = {**_core_args(), **change}
    with pytest.raises(error):
        flat_conv_kernel.flat_conv_core(**args)


def test_plain_calls_are_not_counted():
    before = flat_conv_kernel.launches
    flat_conv_kernel.flat_conv_core(**_core_args())
    assert flat_conv_kernel.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_core_rejects_non_contiguous_on_card(cuda_device):
    args = _core_args()
    args = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
            for k, v in args.items()}
    args["xf"] = torch.zeros(1, 16, 32, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flat_conv_kernel.flat_conv_core(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("c,cout,h,w,stride,k", [
    (32, 64, 40, 256, 1, 3), (32, 64, 40, 256, 2, 3), (8, 8, 16, 1024, 1, 3),
    (32, 48, 21, 256, 1, 1), (128, 128, 23, 64, 1, 3),
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, c, cout, h, w,
                                      stride, k):
    """The CUDA kernel against its plain version on the same device
    tensors; bf16 is compared in the working type (one bf16 step at the
    output's magnitude)."""
    x, wk, b = _inputs(c, cout, h, w, k, seed=5)
    p_out = max(1, 128 // (c * stride))
    layer = tcp.build_flat_layer(wk, b, p_out, stride)
    xf = tcp.to_flat(torch.from_numpy(x).to(cuda_device, dtype),
                     layer["p_in"])
    args = dict(
        xf=xf, wst=torch.from_numpy(layer["wst"]).to(cuda_device, dtype),
        bias=torch.from_numpy(layer["bias"]).to(cuda_device),
        wb=(w // stride) // p_out, h_out=h // stride,
        rowtaps=layer["rowtaps"], s_list=layer["s_list"], act="leaky_relu",
        out_dtype=dtype)
    before = flat_conv_kernel.launches
    out = flat_conv_kernel.flat_conv_core(**args)
    torch.cuda.synchronize()
    assert flat_conv_kernel.launches == before + 1
    ref = flat_conv_kernel.flat_conv_core_plain(**args)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale


# every flat geometry that pack_flat_encoders makes (enc2 / enc3 of a
# band net with pack p1 = 4, 8, 16: stride 2 at p_out = p1/2 and p1/4,
# stride 1 at the same packs), P = 16 at stride 1 (the NHWC wrapper at 8
# channels), the 1x1, and ragged L / NL
GEOMETRIES = [  # (k, stride, cin, cout, p_out)
    (3, 2, 32, 64, 2), (3, 1, 64, 64, 2), (3, 2, 64, 128, 1),
    (3, 1, 128, 128, 1), (3, 2, 16, 32, 4), (3, 1, 32, 32, 4),
    (3, 2, 8, 16, 8), (3, 1, 16, 16, 8), (3, 1, 8, 8, 16),
    (1, 1, 32, 48, 4), (3, 2, 20, 40, 3), (3, 1, 12, 20, 5), (1, 1, 7, 9, 3),
]


def _decode(blocks, wst, ns, dtype):
    """-> (offsets, step codes, lane tiles) of a block_table made at the
    tile of `dtype`, after checking its header."""
    nl = wst.shape[2] // ns
    n_tiles = -(-nl // flat_conv_kernel.TILES[dtype][1])
    b = blocks.numpy().astype(np.int64)
    head = flat_conv_kernel.HEADER
    assert tuple(b[:head]) == (*flat_conv_kernel.TILES[dtype], *wst.shape)
    off, codes = b[head:head + n_tiles + 1], b[head + n_tiles + 1:]
    assert off[0] == 0 and off[-1] == codes.size and np.all(np.diff(off) >= 0)
    return off, codes, n_tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,cin,cout,p_out", GEOMETRIES)
def test_block_table_covers_wst_exactly(k, stride, cin, cout, p_out, dtype):
    """Every non-zero of wst lies in a listed (tap, K slice, shift, lane
    tile) block, and no listed block is all zero, at each dtype's tile."""
    _, wk, b = _inputs(cin, cout, 1, 1, k, seed=cin * cout)
    layer = tcp.build_flat_layer(wk, b, p_out, stride)
    wst = torch.from_numpy(layer["wst"]).to(dtype)
    s_list = layer["s_list"]
    bk, bn = flat_conv_kernel.TILES[dtype]
    blocks = flat_conv_kernel.block_table(wst, s_list)
    assert blocks.dtype == torch.int32 and blocks.dim() == 1
    off, codes, n_tiles = _decode(blocks, wst, len(s_list), dtype)
    n_rt, l_in, nst = wst.shape
    nl = nst // len(s_list)
    w4 = wst.float().numpy().reshape(n_rt, l_in, len(s_list), nl)
    listed = np.zeros(w4.shape, bool)
    for j in range(n_tiles):
        seen = set()
        for code in codes[off[j]:off[j + 1]]:
            t, ks, shifts = code & 3, (code >> 2) & (2 ** 27 - 1), code >> 29 & 7
            assert (t, ks) not in seen and shifts
            seen.add((t, ks))
            for js, s in enumerate(s_list):
                if shifts >> (s + 1) & 1:
                    blk = w4[t, ks * bk:(ks + 1) * bk, js, j * bn:(j + 1) * bn]
                    assert blk.size and np.any(blk != 0), (t, ks, s, j)
                    listed[t, ks * bk:(ks + 1) * bk, js, j * bn:(j + 1) * bn] = True
            assert not shifts & ~sum(1 << (s + 1) for s in s_list)
    assert not np.any((w4 != 0) & ~listed)


def _walk_plain(xf, wst, bias, blocks, dtype, *, wb, h_out, rowtaps, s_list,
                act):
    """The kernel's walk in plain PyTorch: only the listed slices are
    multiplied, each shift's A rows masked by m % wb (the kernel's order
    of work, not its order of the f32 sum)."""
    stride, roffs, h_in, nl = flat_conv_kernel._check(
        xf, wst, bias, wb, h_out, rowtaps, s_list, act, xf.dtype)
    n, _, l_in = xf.shape
    bk, bn = flat_conv_kernel.TILES[dtype]
    m = h_out * wb
    x = xf.reshape(n, h_in, wb, l_in)
    g = torch.arange(m) % wb
    off, codes, n_tiles = _decode(blocks, wst, len(s_list), dtype)
    out = torch.zeros(n, m, nl) + bias
    for j in range(n_tiles):
        cols = slice(j * bn, min((j + 1) * bn, nl))
        for code in codes[off[j]:off[j + 1]]:
            t, ks = code & 3, (code >> 2) & (2 ** 27 - 1)
            kk = slice(ks * bk, min((ks + 1) * bk, l_in))
            for s in range(-1, 2):
                if not code >> 29 >> (s + 1) & 1:
                    continue
                js = s_list.index(s)
                mm = torch.arange(m) + s  # output row m reads row m + s
                a_row, gpos = mm.div(wb, rounding_mode="floor"), mm % wb
                row = stride * a_row + roffs[t]
                keep = (mm >= 0) & (mm < m) & (row >= 0) & (row < h_in)
                keep &= ~((s == -1) & (g == 0)) & ~((s == 1) & (g == wb - 1))
                a = x[:, row.clamp(0, h_in - 1), gpos.clamp(0, wb - 1), kk]
                a = a * keep.reshape(1, m, 1)
                wblk = wst[t, kk, js * nl:(js + 1) * nl][:, cols]
                out[:, :, cols] += a @ wblk
    return flat_conv_kernel._activate(out, act)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,cin,cout,p_out", GEOMETRIES)
def test_walk_over_listed_slices_equals_plain(k, stride, cin, cout, p_out,
                                              dtype):
    """Integer-valued operands make every f32 sum exact, so the walk over
    only the listed slices (at the tile of each dtype) must equal the
    dense plain product bit for bit."""
    rng = np.random.default_rng(cin + cout + p_out)
    wk = rng.integers(-3, 4, (k, k, cin, cout)).astype(np.float32)
    b = rng.integers(-4, 5, cout).astype(np.float32)
    layer = tcp.build_flat_layer(wk, b, p_out, stride)
    h, wb = 6, 3
    x = rng.integers(-3, 4, (2, h, wb * layer["p_in"], cin)).astype(
        np.float32)
    xf = tcp.to_flat(torch.from_numpy(x), layer["p_in"])
    wst = torch.from_numpy(layer["wst"])
    geo = dict(wb=wb, h_out=h // stride, rowtaps=layer["rowtaps"],
               s_list=layer["s_list"], act=None)
    bias = torch.from_numpy(layer["bias"])
    want = flat_conv_kernel.flat_conv_core_plain(
        xf, wst, bias, out_dtype=torch.float32, **geo)
    got = _walk_plain(xf, wst, bias, flat_conv_kernel.block_table(
        wst.to(dtype), layer["s_list"]), dtype, **geo)
    assert torch.equal(got, want)


def test_packed_layers_carry_their_walk():
    """pack_flat_encoders builds each layer's walk once, beside wst; it
    follows the module to a device and is not saved with the weights."""
    from vocal_remover_tpu_torch.models import serving
    from vocal_remover_tpu_torch.models.base_net import FLAT_LAYERS, BaseNet
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet

    model = CascadedNet(256, 128, 8, 16,
                        generator=torch.Generator().manual_seed(0))
    packed = serving.serving_variables(model, "bfloat16", flat=True)
    nets = [m for m in packed.modules()
            if isinstance(m, BaseNet) and m.flat_enc is not None]
    assert nets
    for net in nets:
        for name, _, stride in FLAT_LAYERS:
            lay = net.flat_enc[name]
            s_list = tcp.flat_geometry(3, stride)[1]
            assert lay.s_list == s_list and lay.wst.dtype == torch.bfloat16
            assert lay.blocks.dtype == torch.int32
            assert torch.equal(lay.blocks,
                               flat_conv_kernel.block_table(lay.wst, s_list))
    assert not any(k.endswith(".blocks") for k in packed.state_dict())


# the flat conv's launches on the --flat_conv path at the flagship (crop
# 256, batch 4): the four layers of stg3_full_band_net (F = 1024, c1 = 32,
# p1 = 4) and of stg1_high_band_net (F = 512, c1 = 8, p1 = 16)
FLAGSHIP = [(f"{net} {name}", 4, h, w, cin, cout, stride, p_out)
            for net, bins, c1, p1 in (("stg3_full", 1024, 32, 4),
                                      ("stg1_high", 512, 8, 16))
            for name, h, w, cin, cout, stride, p_out in (
                ("enc2_conv1", bins, 256, c1, 2 * c1, 2, p1 // 2),
                ("enc2_conv2", bins // 2, 128, 2 * c1, 2 * c1, 1, p1 // 2),
                ("enc3_conv1", bins // 2, 128, 2 * c1, 4 * c1, 2, p1 // 4),
                ("enc3_conv2", bins // 4, 64, 4 * c1, 4 * c1, 1, p1 // 4))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,n,h,w,cin,cout,stride,p_out", FLAGSHIP)
def test_kernel_matches_plain_at_flagship_shapes(cuda_device, dtype, label, n,
                                                 h, w, cin, cout, stride,
                                                 p_out):
    """The kernel walking its table against the dense plain version at
    the main path's launch shapes: f32 within 1e-4, bf16 within one bf16
    step (2^-7) of the largest output."""
    rng = np.random.default_rng(len(label))
    wk = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    layer = tcp.build_flat_layer(wk, b, p_out, stride)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin),
                                             dtype=np.float32))
    args = dict(
        xf=tcp.to_flat(x.to(cuda_device, dtype), layer["p_in"]),
        wst=torch.from_numpy(layer["wst"]).to(cuda_device, dtype),
        bias=torch.from_numpy(layer["bias"]).to(cuda_device),
        wb=(w // stride) // p_out, h_out=h // stride,
        rowtaps=layer["rowtaps"], s_list=layer["s_list"], act="leaky_relu",
        out_dtype=dtype)
    blocks = flat_conv_kernel.block_table(args["wst"], layer["s_list"])
    out = flat_conv_kernel.flat_conv_core(**args, blocks=blocks)
    torch.cuda.synchronize()
    ref = flat_conv_kernel.flat_conv_core_plain(**args)
    tol = 1e-4 if dtype == torch.float32 else \
        2.0 ** -7 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_core_rejects_a_foreign_walk_on_card(cuda_device):
    args = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
            for k, v in _core_args().items()}
    with pytest.raises(ValueError, match="block_table"):
        flat_conv_kernel.flat_conv_core(
            **args, blocks=torch.zeros(4, dtype=torch.int64,
                                       device=cuda_device))


def test_apply_drops_a_walk_made_for_another_dtype(monkeypatch):
    """A layer whose wst is cast to the input's dtype on the way in
    cannot use a walk made at its own dtype's tile: the kernel's wrapper
    gets none and builds its own."""
    seen = []

    def core(*args, blocks=None, **kw):
        seen.append(blocks)
        return flat_conv_kernel.flat_conv_core_plain(*args, **kw)

    monkeypatch.setattr(flat_conv_kernel, "flat_conv_core", core)
    _, wk, b = _inputs(32, 64, 1, 1, 3, seed=0)
    layer = tcp.build_flat_layer(wk, b, 2, 1)
    wst = torch.from_numpy(layer["wst"])
    layer["wst"], layer["blocks"] = wst, flat_conv_kernel.block_table(
        wst, layer["s_list"])
    for dtype in (torch.float32, torch.bfloat16):
        xf = torch.zeros(1, 4 * 8, layer["wst"].shape[1], dtype=dtype)
        tcp.flat_layer_apply(layer, xf, 4, 8)
    assert seen[0] is not None and torch.equal(seen[0], layer["blocks"])
    assert seen[1] is None


def _packed_model(seed, dtype=None):
    from vocal_remover_tpu_torch.models import serving
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet

    model = CascadedNet(256, 128, 8, 16,
                        generator=torch.Generator().manual_seed(seed))
    return serving.serving_variables(model, dtype, flat=True)


def _flat_layers(model):
    from vocal_remover_tpu_torch.models.base_net import FlatLayer

    layers = [m for m in model.modules() if isinstance(m, FlatLayer)]
    assert layers
    return layers


def test_flat_layers_rebuild_their_walk_after_a_module_cast():
    """nn.Module.to casts the floating wst but not the int32 walk: each
    FlatLayer rebuilds the walk at the new dtype's tile, and its bias
    stays the float32 it was."""
    packed = _packed_model(0)
    before = {id(m): (m.blocks, m.bias) for m in _flat_layers(packed)}
    packed = packed.to("cpu")  # no cast: the walk stays as it is
    assert all(m.blocks is before[id(m)][0] for m in _flat_layers(packed))
    packed = packed.to(torch.bfloat16)
    for lay in _flat_layers(packed):
        assert lay.wst.dtype == torch.bfloat16
        assert torch.equal(lay.blocks,
                           flat_conv_kernel.block_table(lay.wst, lay.s_list))
        old_blocks, old_bias = before[id(lay)]
        assert not torch.equal(lay.blocks, old_blocks)  # another tile
        assert lay.bias.dtype == torch.float32
        assert torch.equal(lay.bias, old_bias)
    # a dtype the kernel has no tile for leaves no walk to misuse
    assert all(m.blocks is None for m in _flat_layers(packed.half()))


def test_flat_layers_rebuild_their_walk_after_load_state_dict():
    """Weights loaded into a packed model (here: one with a pruned lane
    tile in every wst) bring their own zeros, and so their own walk."""
    packed = _packed_model(0, "bfloat16")
    other = _packed_model(1, "bfloat16")
    state = other.state_dict()
    for k in state:
        if k.endswith(".wst"):
            state[k][:, :, :128] = 0  # the first lane tile of shift -1 / 0
    old = [lay.blocks for lay in _flat_layers(packed)]
    packed.load_state_dict(state)
    for lay, was in zip(_flat_layers(packed), old):
        want = flat_conv_kernel.block_table(lay.wst, lay.s_list)
        assert torch.equal(lay.blocks, want)
        assert not torch.equal(lay.blocks, was)


def test_flat_layers_rebuild_their_walk_after_an_in_place_edit(monkeypatch):
    """An in-place edit of wst, which no hook sees, still reaches the
    kernel with wst's own walk: the forward reads FlatLayer.walk(),
    which holds wst's storage and version against the walk's; a move
    without a cast carries an up-to-date walk along as it is."""
    seen = []
    real = flat_conv_kernel.flat_conv_core

    def core(*args, blocks=None, **kw):
        seen.append((args[1], kw["s_list"], blocks))
        return real(*args, blocks=blocks, **kw)

    monkeypatch.setattr(flat_conv_kernel, "flat_conv_core", core)
    packed = _packed_model(0).eval()
    layers = _flat_layers(packed)
    fresh = [lay.walk() for lay in layers]
    assert all(w is lay.blocks for w, lay in zip(fresh, layers))
    for lay in layers:
        lay.wst[:, :, :128] = 0  # the first lane tile of shift -1 / 0
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 2, 129, 128), dtype=np.float32))
    with torch.inference_mode():
        packed(x)
    assert seen  # the band nets whose shape takes the flat branch
    for wst, s_list, blocks in seen:
        assert torch.equal(blocks, flat_conv_kernel.block_table(wst, s_list))
    for lay, was in zip(layers, fresh):
        walked = lay.walk()  # also the layers the forward did not run
        assert walked is lay.blocks
        assert torch.equal(walked, flat_conv_kernel.block_table(lay.wst,
                                                                lay.s_list))
        assert not torch.equal(walked, was)
        kept = lay.blocks
        lay._apply(lambda t: t)  # a move: the walk goes along
        assert lay.walk() is kept


@pytest.mark.parametrize("made_for", ["other dtype", "other shape", "truncated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_core_rejects_a_walk_made_for_another_tile_or_wst(made_for, dtype):
    """The walk's header names the tile and wst shape it was made for;
    the wrapper checks it before it picks a path, so the CPU refuses
    what the card would."""
    rng = np.random.default_rng(7)
    args = _core_args(dtype=dtype, l_in=64, nl=192)
    args["wst"] = torch.from_numpy(rng.standard_normal(
        tuple(args["wst"].shape), dtype=np.float32)).to(dtype)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    bad = {
        "other dtype": flat_conv_kernel.block_table(
            args["wst"].to(other), args["s_list"]),
        "other shape": flat_conv_kernel.block_table(
            args["wst"][:, :32], args["s_list"]),
        "truncated": flat_conv_kernel.block_table(
            args["wst"], args["s_list"])[:flat_conv_kernel.HEADER - 1],
    }[made_for]
    with pytest.raises(ValueError, match="block_table"):
        flat_conv_kernel.flat_conv_core(**args, blocks=bad)
    good = flat_conv_kernel.block_table(args["wst"], args["s_list"])
    assert torch.equal(flat_conv_kernel.flat_conv_core(**args, blocks=good),
                       flat_conv_kernel.flat_conv_core_plain(**args))
