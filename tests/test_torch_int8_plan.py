"""GPU port: the int8 conv kernel's tile plans (nn/conv_int8_kernel.py
`tile_plan`), checked on the CPU. The kernel (csrc/conv_int8.cu) runs
only on the card; what it is launched with is chosen here in Python, so
every geometry of the flagship's int8 chunks must get a plan that fits
the card's shared memory, and the plan's tiles must cover the output."""

import collections
import ctypes

import pytest
import torch

from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import conv_int8_kernel as ck
from vocal_remover_tpu_torch.nn.layers import Conv2DBNActiv


def _chunk_geometries(crop, batch):
    """{(x shape, q shape, stride, padding, dilation): calls} of the convs
    that `serving.quantize_int8` makes int8 (each Conv2DBNActiv's conv
    outside the BiLSTM branch), from one forward of the flagship on the
    meta device (shapes only)."""
    with torch.device("meta"):
        model = CascadedNet(2048, 1024, 32, 128).eval()
    calls = collections.Counter()

    def hook(mod, args):
        calls[(tuple(args[0].shape), tuple(mod.weight.shape),
               ck._pair(mod.stride), ck._pair(mod.pad),
               ck._pair(mod.dilation))] += 1

    # as serving._quantize_: not the BiLSTM branch's conv
    hooks = [m.conv[0].register_forward_pre_hook(hook)
             for name, m in model.named_modules()
             if isinstance(m, Conv2DBNActiv)
             and "lstm_dec2" not in name.split(".")]
    x = torch.empty(batch, 2, model.output_bin, crop, device="meta")
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return calls


def _assert_sound(plan, x_shape, cout, k, stride, padding, dilation):
    """The plan covers the output, fits shared memory, and its halo tile
    holds every input row and column its taps reach."""
    n, cin, h, w = x_shape
    bm, bn = ck.config_tile(plan["cfg"])
    ho, wo = ck.out_size(x_shape, (cout, cin) + k, stride, padding,
                         dilation)
    assert (plan["ho"], plan["wo"], plan["cp"]) == (
        ho, wo, ck.padded_channels(cin))
    assert plan["th"] * plan["tw"] == bm and plan["tw"] & (plan["tw"] - 1) == 0
    assert plan["tiles_h"] * plan["th"] >= ho > (plan["tiles_h"] - 1) * plan["th"]
    assert plan["tiles_w"] * plan["tw"] >= wo > (plan["tiles_w"] - 1) * plan["tw"]
    assert plan["n_blocks"] * bn >= cout > (plan["n_blocks"] - 1) * bn
    assert bn <= 128 and plan["smem"] <= ck.SMEM_LIMIT
    assert plan["smem"] == ck.plan_smem(plan)
    assert n * plan["tiles_h"] * plan["tiles_w"] * plan["n_blocks"] < 2 ** 31
    assert 1 <= plan["amax_blocks"] <= ck.AMAX_BLOCKS
    if not plan["gather"]:
        (sh, sw), (dh, dw) = stride, dilation
        assert plan["halo_h"] == (plan["th"] - 1) * sh + (k[0] - 1) * dh + 1
        assert plan["halo_w"] == (plan["tw"] - 1) * sw + (k[1] - 1) * dw + 1
        rows, cols = min(plan["halo_h"], h), min(plan["halo_w"], w)
        assert plan["a_rows"] >= rows and plan["a_cols"] >= cols
        esz = 2 if plan["x_bf16"] else 4
        # the 16-byte granules that cover a row of `cols` elements
        assert plan["raw_g"] >= -(-(cols * esz + 15) // 16)


@pytest.mark.parametrize("crop,batch", [(256, 4), (1024, 24)])
def test_every_chunk_geometry_gets_a_halo_plan_that_fits(crop, batch):
    """The 78 distinct geometries of a flagship chunk (97 int8 convs), in
    bf16 (the int8 mode's activations) and in f32: each on the halo
    route, within 227 KB of shared memory."""
    calls = _chunk_geometries(crop, batch)
    assert len(calls) == 78 and sum(calls.values()) == 97
    for (x_shape, q_shape, stride, padding, dilation) in calls:
        for x_bf16 in (True, False):
            plan = ck.tile_plan(x_shape, q_shape[0], q_shape[2:], stride,
                                padding, dilation, x_bf16=x_bf16)
            assert not plan["gather"], (x_shape, q_shape, dilation, x_bf16)
            _assert_sound(plan, x_shape, q_shape[0], q_shape[2:], stride,
                          padding, dilation)


@pytest.mark.parametrize("dilation", [(1, 1), (2, 2), (4, 2), (8, 4),
                                      (12, 6), (24, 12), (40, 40),
                                      (96, 3)])
@pytest.mark.parametrize("hw", [(32, 16), (64, 64), (512, 256), (1, 16)])
def test_every_dilation_gets_a_plan(dilation, hw):
    """ASPP's anisotropic dilations and larger ones, on the bottleneck's
    maps, a large map and a one-row map, in both dtypes and at 3x3 with
    padding = dilation (an output as large as the input): a plan that
    fits, on the gather route only where no halo tile fits."""
    x_shape = (4, 256) + hw
    for x_bf16 in (True, False):
        plan = ck.tile_plan(x_shape, 256, (3, 3), 1, dilation, dilation,
                            x_bf16=x_bf16)
        _assert_sound(plan, x_shape, 256, (3, 3), (1, 1), dilation, dilation)
        if plan["gather"]:
            halo = [ck._tiled(plan, c, False)["smem"]
                    for c in range(len(ck.TILE_CONFIGS))]
            assert min(halo) > ck.SMEM_LIMIT


@pytest.mark.parametrize("cout,width", [(7, 8), (8, 8), (16, 16), (32, 32),
                                        (48, 48), (64, 64), (96, 96),
                                        (128, 128), (192, 96), (256, 128),
                                        (320, 128)])
def test_the_block_width_takes_cout_in_the_fewest_blocks(cout, width):
    """The narrowest block of at most 128 channels that takes Cout in
    ceil(Cout / 128) blocks (192 as two 96s, not 128 + 64)."""
    plan = ck.tile_plan((4, 64, 256, 128), cout, (3, 3), 1, 1, 1)
    assert ck.config_tile(plan["cfg"])[1] == width
    assert plan["n_blocks"] == -(-cout // 128)


def test_small_grids_take_the_small_tile_and_large_ones_the_large():
    """The bottleneck's (4, 256, 32, 16) -> 256 conv has 32 blocks of 128
    pixels: it takes the 32-pixel tile (128 blocks); the largest conv of
    the chunk keeps 256-pixel tiles."""
    small = ck.tile_plan((4, 256, 32, 16), 256, (3, 3), 1, 1, 1)
    assert ck.config_tile(small["cfg"]) == (32, 128)
    large = ck.tile_plan((4, 97, 1024, 256), 32, (3, 3), 1, 1, 1)
    assert ck.config_tile(large["cfg"]) == (256, 32)
    assert (large["th"], large["tw"]) == (16, 16)


def test_plan_fields_match_the_kernels_struct():
    """PLAN_FIELDS is the kernel's `struct Plan`, field by field: the
    ctypes Structure has one int each, in the source's order."""
    src = (ck.build.CSRC / "conv_int8.cu").read_text()
    body = src[src.index("struct Plan {"):]
    body = body[:body.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl.startswith("int "):
            names += [f.strip() for f in decl[4:].split(",")]
    assert tuple(names) == ck.PLAN_FIELDS
    assert ctypes.sizeof(ck.Plan) == 4 * len(ck.PLAN_FIELDS)
    configs = src[src.index("#define CONV_INT8_CONFIGS"):]
    rows = [line for line in configs.splitlines()[1:] if "X(" in line]
    assert tuple(tuple(int(v) for v in r.split("X(")[1].split(")")[0]
                       .split(",")[1:]) for r in rows) == ck.TILE_CONFIGS
