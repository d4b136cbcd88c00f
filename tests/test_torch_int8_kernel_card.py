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
# 32, odd H and W, and one pixel wide
GEOMETRIES = {
    "3x3s1": (26, 32, 3, 1, 1, 1, 64, 48),
    "3x3s2": (48, 64, 3, 2, 1, 1, 33, 47),
    "1x1": (1280, 256, 1, 1, 0, 1, 8, 16),
    "aspp4x2": (64, 40, 3, 1, (4, 2), (4, 2), 16, 24),
    "aspp12x6": (64, 40, 3, 1, (12, 6), (12, 6), 16, 24),
    "ragged": (97, 7, 3, 1, 1, 1, 5, 1),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


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
    q = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k),
                                      dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    a = torch.tensor(np.float32(x.abs().max().item() * 0.6 / 127.0))
    q, scale = q.to(cuda_device), scale.to(cuda_device)
    packed = ck.pack_weights(q)
    for x_dtype in (torch.bfloat16, torch.float32):
        xd = x.to(cuda_device, x_dtype)
        for a_scale in (None, a.to(cuda_device)):
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
                assert torch.equal(got, want), (geom, x_dtype, a_scale,
                                                out_dtype)
