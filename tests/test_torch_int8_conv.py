"""GPU port: the int8 serving conv (nn/conv_int8_kernel.py) against the
JAX package's `conv2d_int8` (vocal_remover_tpu/nn/functional.py:24-63):
the same int32 sums and the same output bit for bit; the wrapper's
checks; the QConv2d holder. The kernel itself is held to the plain
version on the card by tests/test_torch_int8_kernel_card.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.nn import functional as JF
from vocal_remover_tpu_torch.nn import config as tconfig
from vocal_remover_tpu_torch.nn import conv_int8_kernel as ck
from vocal_remover_tpu_torch.nn import functional as TF
from vocal_remover_tpu_torch.nn.layers import QConv2d

torch.set_num_threads(1)

# (cin, cout, k, stride, padding, dilation): enc1's 3x3 (Cin not a
# multiple of 16), an encoder's stride-2 3x3, a 1x1, ASPP's anisotropic
# dilated 3x3s
GEOMETRIES = {
    "3x3s1": (10, 16, 3, 1, 1, 1),
    "3x3s2": (16, 32, 3, 2, 1, 1),
    "1x1": (48, 8, 1, 1, 0, 1),
    "aspp4x2": (32, 24, 3, 1, (4, 2), (4, 2)),
    "aspp12x6": (32, 24, 3, 1, (12, 6), (12, 6)),
}


def _case(geom, seed=0):
    """NHWC input, int8 HWIO kernel and scales as JAX's quantize_int8
    makes them, and a static activation scale below the input's amax
    (so that some values saturate at +-127)."""
    cin, cout, k = geom[:3]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 22, 26, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    scale = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-30) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    a = np.float32(np.abs(x).max() * 0.6 / 127.0)
    return x, q, scale.astype(np.float32), a


def _torch_args(x, q, scale, a, static, bf16):
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    qt = torch.from_numpy(np.ascontiguousarray(q.transpose(3, 2, 0, 1)))
    return ((xt.bfloat16() if bf16 else xt), qt, torch.from_numpy(scale),
            torch.tensor(a) if static else None)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("geom", list(GEOMETRIES), ids=list(GEOMETRIES))
def test_plain_matches_jax_bit_for_bit(geom, static, dtype):
    """The int32 sums are equal, and the dequantized output (in the
    compute dtype of the mode) is bit-identical."""
    cin, cout, k, stride, pad, dil = GEOMETRIES[geom]
    x, q, scale, a = _case(GEOMETRIES[geom])
    bf16 = dtype == "bf16"
    leaf = {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}
    if static:
        leaf["a_scale"] = jnp.asarray(a)
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    with jconfig.precision("bfloat16" if bf16 else "highest"):
        want = np.asarray(JF.conv2d_int8(xj, leaf, stride, pad, dil)
                          .astype(jnp.float32))
    # JAX's int32 sums, from the same quantization steps
    xf = xj.astype(jnp.float32)
    a_used = leaf.get("a_scale", jnp.maximum(jnp.max(jnp.abs(xf)) / 127.0,
                                             jnp.float32(1e-30)))
    xq = jnp.clip(jnp.round(xf / a_used), -127, 127).astype(jnp.int8)
    s, p, d = JF._conv_geometry(stride, pad, dil)
    sums = np.asarray(jax.lax.conv_general_dilated(
        xq, leaf["q"], s, p, rhs_dilation=d,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))

    xt, qt, st, at = _torch_args(x, q, scale, a, static, bf16)
    acc, a_t = ck.conv2d_int8_sums(xt, qt, at, stride=stride, padding=pad,
                                   dilation=dil)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(np.moveaxis(acc.numpy(), 1, -1), sums)
    assert np.float32(a_t.item()) == np.asarray(a_used)
    out = ck.conv2d_int8_plain(xt, qt, st, at, stride=stride, padding=pad,
                               dilation=dil, out_dtype=xt.dtype)
    assert out.dtype == xt.dtype
    np.testing.assert_array_equal(np.moveaxis(out.float().numpy(), 1, -1),
                                  want)


def test_functional_conv_follows_the_compute_dtype_and_counts_no_launch():
    """F.conv2d_int8 takes any input layout (a sliced, non-contiguous
    view here, as the band split makes), returns the compute dtype, and
    on the CPU runs the plain version without counting a launch."""
    x, q, scale, a = _case(GEOMETRIES["3x3s1"])
    xt, qt, st, _ = _torch_args(x, q, scale, a, False, False)
    view = xt[:, :, 2:18]
    assert not view.is_contiguous()
    pk = ck.pack_weights(qt)
    before = ck.launches
    with tconfig.precision("bfloat16"):
        y16 = TF.conv2d_int8(view, qt, st, packed=pk)
    with tconfig.precision("highest"):
        y32 = TF.conv2d_int8(view, qt, st, packed=pk)
    assert ck.launches == before
    assert y16.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert torch.equal(y16, y32.bfloat16())
    assert torch.equal(y32, ck.conv2d_int8_plain(view.contiguous(), qt, st))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, q, scale, a = _case(GEOMETRIES["3x3s1"])
    xt, qt, st, at = _torch_args(x, q, scale, a, True, False)
    pk = ck.pack_weights(qt)
    with pytest.raises(TypeError, match="float32"):  # a module cast to bf16
        ck.conv2d_int8(xt, qt, st.bfloat16(), at, packed=pk)
    with pytest.raises(TypeError, match="float32"):
        ck.conv2d_int8(xt, qt, st, at.bfloat16(), packed=pk)
    with pytest.raises(TypeError, match="int8"):
        ck.conv2d_int8(xt, qt.float(), st, at, packed=pk)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ck.conv2d_int8(xt.double(), qt, st, at, packed=pk)
    with pytest.raises(ValueError, match="do not fit"):
        ck.conv2d_int8(xt[:, :5], qt, st, at, packed=pk)
    with pytest.raises(ValueError, match="one value"):
        ck.conv2d_int8(xt, qt, st, torch.ones(2), packed=pk)
    with pytest.raises(ValueError, match="empty output"):
        ck.conv2d_int8(xt[:, :, :1, :1], qt, st, at, padding=0, packed=pk)
    with pytest.raises(ValueError, match="pack_weights"):  # q's, unpacked
        ck.conv2d_int8(xt, qt, st, at, packed=qt.reshape(qt.shape[0], -1))
    with pytest.raises(ValueError, match="pack_weights"):
        ck.conv2d_int8(xt, qt, st, at, packed=pk.float())


def test_qconv_holder_keeps_its_buffers_and_refuses_a_bf16_cast():
    """The int8 conv holder: buffers only (nothing a trainer could
    update), `packed` rebuilt on load and not saved; `.to(bfloat16)`
    casts its float scales, which the wrapper then refuses (it does not
    run on bf16 scales)."""
    x, q, scale, a = _case(GEOMETRIES["aspp4x2"])
    xt, qt, st, at = _torch_args(x, q, scale, a, True, False)
    mod = QConv2d(qt, st, at, 1, (4, 2), (4, 2))
    assert list(mod.parameters()) == []
    assert set(mod.state_dict()) == {"q", "scale", "a_scale"}
    np.testing.assert_array_equal(
        mod.packed.reshape(24, 3, 3, 32).numpy(),
        q.transpose(3, 0, 1, 2))
    other = QConv2d(torch.zeros_like(qt), torch.ones(24), torch.ones(()),
                    1, (4, 2), (4, 2))
    other.load_state_dict(mod.state_dict())
    assert torch.equal(other.packed, mod.packed)
    with tconfig.precision("highest"):
        assert torch.equal(other(xt), ck.conv2d_int8_plain(
            xt, qt, st, at, padding=(4, 2), dilation=(4, 2)))
    with pytest.raises(TypeError, match="float32"):
        mod.to(torch.bfloat16)(xt)


def test_pack_weights_pads_channels_to_the_kernels_multiple():
    """Cin 40 -> Cp 64, two chunks of 32 channels; per output channel
    each chunk holds its 9 taps' 32 channels, the padding zero."""
    assert ck.CHANNEL_PAD == 32
    q = torch.randint(-127, 128, (5, 40, 3, 3), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0))
    packed = ck.pack_weights(q)
    assert packed.shape == (5, 9 * 64) and ck.padded_channels(40) == 64
    assert packed.is_contiguous()
    p = packed.reshape(5, 2, 3, 3, 32)
    assert torch.equal(p[:, 0], q[:, :32].permute(0, 2, 3, 1))
    assert torch.equal(p[:, 1, ..., :8], q[:, 32:].permute(0, 2, 3, 1))
    assert not p[:, 1, ..., 8:].any()
    assert ck.padded_channels(2) == 32 and ck.padded_channels(1280) == 1280
