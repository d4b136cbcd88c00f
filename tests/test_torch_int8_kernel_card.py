"""GPU port: the int8 conv kernel (csrc/conv_int8.cu) against its plain
version on the card, bit for bit. `cuda`-marked: skips without a card.
Imports no JAX, so that it runs on a machine without it."""

import numpy as np
import pytest
import torch

from vocal_remover_tpu_torch.nn import conv_int8_kernel as ck

# (cin, cout, k, stride, padding, dilation, H, W): the model's kinds of
# conv (enc1's Cin 26 -> 32, a stride-2 encoder conv, the 1x1 bottleneck
# of Cin 1280, ASPP's dilated pairs), Cout not a multiple of the block's
# channels, odd H and W, and one pixel wide; then the edges of the tile
# plans: maps that are not multiples of the tile, H = 1, Cin 2 and Cout 8,
# Cout 256 at 3x3, stride 2 on odd sizes in a 256-pixel tile, ASPP's
# (12, 6) on 32 x 16, where the halo exceeds the tile, and a dilation
# whose halo tile does not fit shared memory (the gather route)
GEOMETRIES = {
    "3x3s1": (26, 32, 3, 1, 1, 1, 64, 48),
    "3x3s2": (48, 64, 3, 2, 1, 1, 33, 47),
    "1x1": (1280, 256, 1, 1, 0, 1, 8, 16),
    "aspp4x2": (64, 40, 3, 1, (4, 2), (4, 2), 16, 24),
    "aspp12x6": (64, 40, 3, 1, (12, 6), (12, 6), 16, 24),
    "ragged": (97, 7, 3, 1, 1, 1, 5, 1),
    "ragged_tiles": (32, 64, 3, 1, 1, 1, 37, 23),
    "h1_3x3": (16, 32, 3, 1, 1, 1, 1, 9),
    "h1_1x1": (64, 64, 1, 1, 0, 1, 1, 16),
    "cin2_cout8": (2, 8, 3, 1, 1, 1, 40, 33),
    "cout256": (256, 256, 3, 1, 1, 1, 32, 16),
    "s2_odd_wide": (16, 32, 3, 2, 1, 1, 35, 19),
    "aspp12x6_32x16": (128, 128, 3, 1, (12, 6), (12, 6), 32, 16),
    "gather": (24, 16, 3, 1, (40, 40), (40, 40), 96, 120),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _weights(rng, cin, cout, k, device):
    q = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k),
                                      dtype=np.int8)).to(device)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout)
                             .astype(np.float32)).to(device)
    return q, scale, ck.pack_weights(q)


def _held(x, q, scale, packed, a_scales, geom, x_dtypes=None):
    """Every dtype of x and out, each a_scale: the kernel equals the plain
    version bit for bit, one launch counted a call. `x_dtypes`: the
    inputs to hold, by default x in bf16 and in f32."""
    stride, pad, dil = geom
    if x_dtypes is None:
        x_dtypes = [x.to(dt) for dt in (torch.bfloat16, torch.float32)]
    for xd in x_dtypes:
        x_dtype = xd.dtype
        for a_scale in a_scales:
            for out_dtype in (torch.bfloat16, torch.float32):
                before = ck.launches
                got = ck.conv2d_int8(xd, q, scale, a_scale, packed=packed,
                                     stride=stride, padding=pad,
                                     dilation=dil, out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert ck.launches == before + 1
                want = ck.conv2d_int8_plain(xd, q, scale, a_scale,
                                            stride=stride, padding=pad,
                                            dilation=dil,
                                            out_dtype=out_dtype)
                assert torch.equal(got, want), (x_dtype, a_scale, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(GEOMETRIES), ids=list(GEOMETRIES))
def test_kernel_matches_plain_on_card(cuda_device, geom):
    """bf16 and f32 in and out, dynamic and static scale (the static one
    below the input's amax, so that some values saturate): equal to the
    plain version bit for bit, one launch counted a call."""
    cin, cout, k, stride, pad, dil, h, w = GEOMETRIES[geom]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, cin, h, w),
                                             dtype=np.float32))
    q, scale, packed = _weights(rng, cin, cout, k, cuda_device)
    a = torch.tensor(np.float32(x.abs().max().item() * 0.6 / 127.0))
    plan = ck.tile_plan(x.shape, cout, (k, k), stride, pad, dil)
    assert plan["gather"] == (geom == "gather")
    _held(x.to(cuda_device), q, scale, packed, (None, a.to(cuda_device)),
          (stride, pad, dil))


@pytest.mark.cuda
def test_kernel_reads_an_unaligned_x(cuda_device):
    """x a contiguous view at storage offset 1 (its rows start off the
    16-byte granules the kernel copies): still exact."""
    rng = np.random.default_rng(6)
    shape = (2, 40, 21, 35)
    q, scale, packed = _weights(rng, 40, 48, 3, cuda_device)
    src = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    a = torch.tensor(np.float32(src.abs().max().item() * 0.6 / 127.0),
                     device=cuda_device)
    views = []
    for x_dtype in (torch.bfloat16, torch.float32):
        flat = torch.empty(src.numel() + 1, dtype=x_dtype,
                           device=cuda_device)
        x = flat[1:].view(shape)
        x.copy_(src)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        views.append(x)
    _held(src, q, scale, packed, (None, a), (1, 1, 1), x_dtypes=views)


@pytest.mark.cuda
def test_kernel_on_an_all_zero_x(cuda_device):
    """amax 0: the dynamic scale is 1e-30, and the output all zeros, as in
    the plain version (and with a static scale)."""
    rng = np.random.default_rng(7)
    q, scale, packed = _weights(rng, 33, 20, 3, cuda_device)
    x = torch.zeros(2, 33, 17, 30)
    a = torch.tensor(np.float32(0.01), device=cuda_device)
    _held(x.to(cuda_device), q, scale, packed, (None, a), (1, 1, 1))


@pytest.mark.cuda
def test_kernel_rounds_half_way_points_to_even(cuda_device):
    """x / a_scale exactly k + 0.5 for every k in [-127, 126], and one
    bf16 step and one float32 step either side of such points, with a
    power-of-two scale (the dynamic one too: amax 127/16 gives 1/16), so
    that round half to even decides each value: exact."""
    rng = np.random.default_rng(8)
    half = ((np.arange(-127, 127) + 0.5) / 16.0).astype(np.float32)
    step = (2.0 ** (np.floor(np.log2(np.abs(half))) - 7)).astype(np.float32)
    vals = np.concatenate([half, half + step, half - step,
                           np.nextafter(half, np.float32(np.inf)),
                           np.nextafter(half, np.float32(-np.inf))])
    cin, h, w = 32, 12, 20
    x = rng.choice(vals, size=(2, cin, h, w)).astype(np.float32)
    x[0, 0, 0, 0] = 127.0 / 16.0
    q, scale, packed = _weights(rng, cin, 16, 3, cuda_device)
    a = torch.tensor(np.float32(1.0 / 16.0), device=cuda_device)
    _held(torch.from_numpy(x).to(cuda_device), q, scale, packed, (None, a),
          (1, 1, 1))
