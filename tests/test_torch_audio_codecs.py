"""GPU port: the native audio decoders (FLAC, MP3, AAC-LC, HE-AAC), their
build, the FLAC writer and `audio.load` on compressed files, against the
JAX package's, in one process. The streams are written without an
oracle: FLAC by the JAX package's `encode_flac`, MP3 and AAC by the
bitstream writers under scripts/."""

import os
import shutil
import sys

import numpy as np
import pytest

from vocal_remover_tpu import native as jnative
from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu.utils import flac as jflac
from vocal_remover_tpu_torch import native
from vocal_remover_tpu_torch.native import build
from vocal_remover_tpu_torch.utils import audio, flac

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import aac_lc_encode as lc  # noqa: E402
from aac_bitstream import CPE, BitWriter, adts_frame  # noqa: E402
from mp3_bitstream import Granule, build_frame, probe_stream, silent  # noqa: E402

# MP3 Huffman table 1 codes: (x, y) -> bits; a (1, 1) pair with signs
T1 = {(0, 0): "1", (0, 1): "001", (1, 0): "01", (1, 1): "000"}
PAIR = T1[(1, 1)] + "00"


@pytest.fixture(scope="module", autouse=True)
def jax_decoders():
    if jnative.get() is None:
        pytest.skip("the JAX package's native extension does not build")


def _pcm(shape, bps, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[0])[:, None]
    lim = (1 << (bps - 1)) - 1
    x = 0.4 * lim * np.sin(2 * np.pi * t * (0.01 + 0.003 * np.arange(
        shape[1]))) + rng.normal(0, 0.02 * lim, shape)
    return np.clip(np.round(x), -lim, lim).astype(np.int64)


FLAC_CASES = {
    "16bit-stereo": dict(bps=16, ch=2),
    "16bit-mono": dict(bps=16, ch=1),
    "24bit-stereo-mid_side": dict(bps=24, ch=2, stereo="mid_side"),
    "24bit-mono-lpc2": dict(bps=24, ch=1, method="lpc2"),
    "16bit-left_side-rice2": dict(bps=16, ch=2, stereo="left_side",
                                  residual_method=1, partition_order=3),
    "16bit-verbatim": dict(bps=16, ch=2, method="verbatim"),
    "16bit-fixed2-escape": dict(bps=16, ch=2, method="fixed2", escape=True,
                                partition_order=2),
}


def flac_bytes(case, n=10000):
    kw = dict(FLAC_CASES[case])
    bps, ch = kw.pop("bps"), kw.pop("ch")
    return jflac.encode_flac(_pcm((n, ch), bps), 22050, bps, **kw)


def mp3_bytes(case):
    if case == "long":
        return probe_stream([Granule(bits=PAIR * 20, big_values=20,
                                     table_select=(1, 1, 1))] * 6)
    if case == "short-gains":
        return probe_stream([Granule(
            bits=PAIR * 3, big_values=3, window_switching=1, block_type=2,
            table_select=(1, 1, 0), subblock_gain=(1, 2, 3))] * 4)
    if case == "mixed":
        return probe_stream([Granule(
            bits=PAIR * 4, big_values=4, window_switching=1, block_type=2,
            mixed_block=1, table_select=(1, 1, 0))] * 4)
    if case == "ms-stereo":
        ga = Granule(bits=PAIR * 30, big_values=30, table_select=(1, 1, 1))
        gb = Granule(bits=(T1[(1, 0)] + "0") * 30, big_values=30,
                     table_select=(1, 1, 1))
        sil = [silent(), silent()]
        return b"".join(
            build_frame([[ga, gb], sil], mode=1, mode_ext=2)
            + build_frame([sil, sil], mode=1, mode_ext=2) for _ in range(4))
    if case == "mpeg2":
        return probe_stream([Granule(bits=PAIR * 20, big_values=20,
                                     table_select=(1, 1, 1))] * 6, version=2)
    raise ValueError(case)


def _sce(rng, sr):
    return lc.encode_sce(lc.dense_spectrum(sr, 200, 9000, rng=rng), sr,
                         global_gain=170)


def aac_lc_bytes(ch, sr=44100, frames=12, seed=0):
    """An AAC-LC ADTS stream of `frames` dense-spectrum frames."""
    rng = np.random.default_rng(seed)
    return b"".join(adts_frame(
        [CPE(left=_sce(rng, sr), right=_sce(rng, sr)) if ch == 2
         else _sce(rng, sr)], sr=sr, channel_config=ch)
        for _ in range(frames))


def he_aac_bytes(frames=16, seed=3):
    """A mono HE-AAC ADTS stream (22.05 kHz core, SBR to 44.1 kHz), built
    as tests/test_sbr.py builds it."""
    import sbr_bitstream as sb
    import sbr_parse as sp

    hdr = sb.SbrHeader(amp_res=1, start_freq=5, stop_freq=5, xover_band=0)
    ft = hdr.tables(44100)
    chan = sb.SbrChannel(num_env=1, freq_res=[0], df_env=[0], df_noise=[0],
                         invf=[2] * ft.n_q, env_sf=[[24] * ft.n_low],
                         noise_sf=[[10] * ft.n_q])
    huff = sp.Books().writer_huff(chan.amp_res_used(hdr.amp_res))
    rng = np.random.default_rng(seed)
    return b"".join(adts_frame([_sce(rng, 22050), sb.sbr_fil(sb.SbrData(
        header=hdr, channels=[chan], fs_sbr=44100, huff=huff,
        send_header=(i == 0)))], sr=22050) for i in range(frames))


def m4a_bytes(adts: bytes, sf_index: int, ch: int) -> bytes:
    """The raw AAC-LC blocks of an ADTS stream in a minimal ISO-BMFF
    file (one track, one chunk, mdat last)."""
    import struct

    samples, pos = [], 0
    while pos + 7 <= len(adts):
        n = ((adts[pos + 3] & 3) << 11) | (adts[pos + 4] << 3) | (
            adts[pos + 5] >> 5)
        samples.append(adts[pos + 7:pos + n])
        pos += n
    w = BitWriter()
    for v, bits in ((2, 5), (sf_index, 4), (ch, 4), (0, 3)):
        w.put(v, bits)
    asc = w.tobytes()

    def box(typ, payload):
        return struct.pack(">I", 8 + len(payload)) + typ + payload

    esds = box(b"esds", b"\x00" * 4 + b"\x03\x19\x00\x00\x00"
               + b"\x04\x11\x40\x15" + b"\x00" * 11
               + bytes([0x05, len(asc)]) + asc)
    stsd = box(b"stsd", b"\x00" * 4 + struct.pack(">I", 1)
               + box(b"mp4a", b"\x00" * 28 + esds))
    stsz = box(b"stsz", b"\x00" * 4 + struct.pack(">II", 0, len(samples))
               + b"".join(struct.pack(">I", len(s)) for s in samples))
    stsc = box(b"stsc", b"\x00" * 4 + struct.pack(">IIII", 1, 1,
                                                  len(samples), 1))
    hdlr = box(b"hdlr", b"\x00" * 8 + b"soun" + b"\x00" * 12)

    def head(offset):
        stco = box(b"stco", b"\x00" * 4 + struct.pack(">II", 1, offset))
        stbl = box(b"stbl", stsd + stsz + stsc + stco)
        trak = box(b"trak", box(b"mdia", hdlr + box(b"minf", stbl)))
        return box(b"ftyp", b"M4A \x00\x00\x00\x00") + box(b"moov", trak)

    return head(len(head(0)) + 8) + box(b"mdat", b"".join(samples))


AAC_CASES = {
    "lc-mono": lambda: aac_lc_bytes(1),
    "lc-stereo": lambda: aac_lc_bytes(2),
    "lc-mono-22050": lambda: aac_lc_bytes(1, sr=22050),
    "lc-stereo-m4a": lambda: m4a_bytes(aac_lc_bytes(2), 4, 2),
    "he-aac": he_aac_bytes,
}


def _jax_decode(kind, data):
    return getattr(jnative, f"{kind}_decode")(data)


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_decode_matches_jax(case):
    data = flac_bytes(case)
    pcm, sr, bps = native.flac_decode(data)
    want, wsr, wbps = _jax_decode("flac", data)
    assert pcm.dtype == np.int32 and (sr, bps) == (wsr, wbps)
    np.testing.assert_array_equal(pcm, want)
    np.testing.assert_array_equal(pcm, _pcm(pcm.shape, bps))


@pytest.mark.parametrize("case", ["long", "short-gains", "mixed", "ms-stereo",
                                  "mpeg2"])
def test_mp3_decode_matches_jax(case):
    data = mp3_bytes(case)
    pcm, sr = native.mp3_decode(data)
    want, wsr = _jax_decode("mp3", data)
    assert pcm.dtype == np.float32 and sr == wsr and pcm.shape == want.shape
    assert np.abs(pcm).max() > 0
    np.testing.assert_array_equal(pcm, want)


@pytest.mark.parametrize("case", sorted(AAC_CASES))
def test_aac_decode_matches_jax(case):
    data = AAC_CASES[case]()
    pcm, sr = native.aac_decode(data)
    want, wsr = _jax_decode("aac", data)
    assert pcm.dtype == np.float32 and sr == wsr and pcm.shape == want.shape
    assert sr == (44100 if case != "lc-mono-22050" else 22050)
    assert np.abs(pcm).max() > 0
    np.testing.assert_array_equal(pcm, want)


@pytest.mark.parametrize("kind", ["flac", "mp3", "aac"])
@pytest.mark.parametrize("bad", [b"", bytes(range(256)) * 40,
                                 b"RIFFnotflacnotflacnotflacnotflac",
                                 b"\xff\xfd\x90\x00" + bytes(400)],
                         ids=["empty", "ramp", "riff", "layer2"])
def test_garbage_is_rejected_as_in_jax(kind, bad):
    with pytest.raises(ValueError) as ours:
        getattr(native, f"{kind}_decode")(bad)
    with pytest.raises(ValueError) as theirs:
        _jax_decode(kind, bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("ext", [".flac", ".mp3", ".m4a", ".mp4", ".aac"])
@pytest.mark.parametrize("sr", [None, 16000])
def test_load_matches_jax(tmp_path, ext, sr):
    """`audio.load` on a compressed file equals the JAX package's, its
    resampling included."""
    path = str(tmp_path / f"song{ext}")
    if ext == ".flac":
        data = flac_bytes("16bit-stereo", n=30000)
    elif ext == ".mp3":
        data = mp3_bytes("long")
    elif ext == ".aac":
        data = aac_lc_bytes(2)
    else:
        data = m4a_bytes(aac_lc_bytes(2), 4, 2)
    with open(path, "wb") as f:
        f.write(data)
    got, got_sr = audio.load(path, sr=sr)
    want, want_sr = jaudio.load(path, sr=sr)
    assert got_sr == want_sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_sends_a_rejected_stream_to_ffmpeg(tmp_path, monkeypatch):
    """A stream its native decoder rejects goes to ffmpeg, which is not
    on PATH here: the same error type as the JAX package's."""
    path = str(tmp_path / "bad.mp3")
    with open(path, "wb") as f:
        f.write(bytes(range(256)) * 4)
    monkeypatch.setattr(audio, "_FFMPEG", None)
    monkeypatch.setattr(jaudio, "_FFMPEG", None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        audio.load(path)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        jaudio.load(path)


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_encode_flac_matches_jax(case):
    kw = dict(FLAC_CASES[case])
    bps, ch = kw.pop("bps"), kw.pop("ch")
    pcm = _pcm((9000, ch), bps, seed=1)
    assert flac.encode_flac(pcm, 44100, bps, **kw) == jflac.encode_flac(
        pcm, 44100, bps, **kw)


def test_write_flac_round_trip(tmp_path):
    wave = (np.round(0.5 * np.sin(np.arange(6000) * 0.03)[None] * np.array(
        [[1.0], [0.5]]) * 32768) / 32768).astype(np.float32)
    path = str(tmp_path / "x.flac")
    flac.write_flac(path, wave, 44100)
    got, sr = audio.load(path, sr=None)
    assert sr == 44100
    np.testing.assert_array_equal(got, wave)


def test_extension_lands_in_build_dir():
    """One module of its own name, in build/torch_native/ at the root of
    the checkout, with the three decoders, the four host kernels
    (native/host.c) and none of the JAX package's test hooks."""
    path = build.build()
    assert str(path.parent) == os.path.join(ROOT, "build", "torch_native")
    mod = build.load()
    assert mod.__name__ == "_vrtnative_torch" and mod.__file__ == str(path)
    assert sorted(n for n in dir(mod) if not n.startswith("_")) == [
        "aac_decode", "flac_decode", "load_crop_abs", "mp3_decode",
        "pcm16_decode", "pcm16_encode", "quantize_u8"]


def test_edited_source_is_rebuilt(tmp_path, monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(build.SRC_DIR, src, ignore=shutil.ignore_patterns(
        "*.py", "__pycache__"))
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.build()
    assert build.build() == first  # unchanged: reused
    with open(src / "decoders.c", "a") as f:
        f.write("\n/* edited */\n")
    second = build.build()
    assert second != first and first.exists() and second.exists()


def test_failing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CC", "false")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="false failed building"):
        build.build()
    assert not list(tmp_path.iterdir())
