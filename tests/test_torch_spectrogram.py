"""GPU port: the spectrogram path (host STFT / iSTFT, `Separator.separate`
/ `separate_tta`, `--postprocess`, `--output_image`), `.pth` checkpoints
and `--profile` against the JAX package on the CPU (the recurrence under
its plain versions on both sides)."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.cli import inference as jcli
from vocal_remover_tpu.models import convert as jconvert
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.ops import stft as jstft
from vocal_remover_tpu.separate.separator import Separator as JSeparator
from vocal_remover_tpu.utils import image as jimage
from vocal_remover_tpu.utils import spec as jspec
from vocal_remover_tpu_torch.cli import inference as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.ops import stft as tstft
from vocal_remover_tpu_torch.separate.separator import Separator
from vocal_remover_tpu_torch.utils import audio, image, spec

from torch_port_helpers import max_lsb, perturb_bn, small_pair, synth_song

torch.set_num_threads(1)

SR = 8000
N_FFT, HOP = 256, 128
# JAX's bound between the spectrogram path's and the streamed
# postprocess (tests/test_streaming.py), 4e-4 of full scale = 13.1 LSB,
# plus the PCM16 rounding of both stems
STREAM_POSTPROCESS_LSB = 14


@pytest.fixture(scope="module")
def pairs():
    """Magnitude and complex-mask CascadedNet(256, 128, 8, 16): (JAX
    module, its variables, the port's module with the same weights)."""
    jcx = JCascadedNet(N_FFT, HOP, 8, 16, is_complex=True)
    vcx = perturb_bn(jcx.init(jax.random.PRNGKey(11)),
                     np.random.default_rng(11))
    tcx = convert.from_jax_variables(
        CascadedNet(N_FFT, HOP, 8, 16, is_complex=True), vcx)
    return {"magnitude": small_pair(), "complex": (jcx, vcx, tcx)}


@pytest.fixture(scope="module")
def ckpt(pairs, tmp_path_factory):
    _, v, tmod = pairs["magnitude"]
    path = str(tmp_path_factory.mktemp("ckpt") / "small.vrt.npz")
    convert.save_native(path, v, convert.model_config(tmod))
    return path


@pytest.mark.parametrize("n_fft,hop,n", [(256, 128, 3001), (2048, 1024, 11025),
                                         (512, 128, 4000)])
def test_stft_np_matches_jax(rng, n_fft, hop, n):
    """Host STFT / iSTFT within 1e-6 of the JAX package's; the round trip
    at `length=` gives the wave back on the samples the frames cover
    (hop * (n // hop)) and zeros after them."""
    wave = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    X = tstft.stft_np(wave, n_fft, hop)
    want = jstft.stft_np(wave, n_fft, hop)
    assert X.dtype == np.complex64 and X.shape == want.shape
    np.testing.assert_allclose(X, want, atol=1e-6)
    for length in (None, n, n + 300):
        y = tstft.istft_np(X, n_fft, hop, length)
        ref = jstft.istft_np(want, n_fft, hop, length)
        assert y.dtype == np.float32 and y.shape == ref.shape
        np.testing.assert_allclose(y, ref, atol=1e-6)
    back, cov = tstft.istft_np(X, n_fft, hop, n), hop * (n // hop)
    np.testing.assert_allclose(back[:, :cov], wave[:, :cov], atol=1e-5)
    assert not back[:, cov:].any()


@pytest.mark.parametrize("mode", ["magnitude", "phase"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_spectrogram_to_image_matches_jax(rng, mode, ndim):
    X = tstft.stft_np(rng.uniform(-1, 1, (2, 3000)).astype(np.float32),
                      N_FFT, HOP)
    X = X if ndim == 3 else X[0]
    img = spec.spectrogram_to_image(X, mode)
    want = jspec.spectrogram_to_image(X, mode)
    assert img.dtype == np.uint8 and img.shape == want.shape
    np.testing.assert_array_equal(img, want)


def _image(rng):
    X = tstft.stft_np(rng.uniform(-1, 1, (2, 2000)).astype(np.float32),
                      N_FFT, HOP)
    return spec.spectrogram_to_image(X)


def test_imwrite_with_pil_matches_jax(rng, tmp_path):
    pytest.importorskip("PIL")
    img = _image(rng)
    assert image.imwrite(str(tmp_path / "a.jpg"), img)
    assert jimage.imwrite(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


@pytest.mark.parametrize("shape", ["rgb", "gray"])
def test_imwrite_without_pil_writes_jax_png(rng, tmp_path, monkeypatch, shape):
    """With PIL hidden the stdlib writer takes over, swaps the extension
    to .png, and writes the bytes of the JAX package's `_write_png`."""
    img = _image(rng)
    img = img if shape == "rgb" else img[:, :, 0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert image.imwrite(str(tmp_path / "a.jpg"), img)
    assert not (tmp_path / "a.jpg").exists()
    jimage._write_png(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


@pytest.mark.parametrize("kind", ["magnitude", "complex"])
@pytest.mark.parametrize("postprocess", [False, True])
@pytest.mark.parametrize("tta", [False, True])
def test_separate_matches_jax(pairs, kind, postprocess, tta):
    """(y_spec, v_spec) of the spectrogram API within 2e-5 of |X|'s max
    of the JAX Separator's, on a song whose patch count is not a whole
    number of chunks."""
    jmod, v, tmod = pairs[kind]
    wave = synth_song(SR, 3.3)
    X = tstft.stft_np(wave, N_FFT, HOP)
    ours = Separator(tmod, batchsize=2, cropsize=256, device="cpu",
                     postprocess=postprocess)
    theirs = JSeparator(jmod, v, batchsize=2, cropsize=256,
                        postprocess=postprocess)
    go = ours.separate_tta if tta else ours.separate
    want = (theirs.separate_tta if tta else theirs.separate)(X)
    atol = 2e-5 * float(np.abs(X).max())
    for a, b in zip(go(X), want):
        assert a.shape == b.shape == X.shape and np.iscomplexobj(a)
        np.testing.assert_allclose(a, b, atol=atol)


def test_separate_waves_refuses_postprocess(pairs):
    sp = Separator(pairs["magnitude"][2], device="cpu", postprocess=True)
    with pytest.raises(ValueError, match="spectrogram API"):
        sp.separate_wave(synth_song(SR, 1.0))


def _stems(out, name="song"):
    return [np.round(audio.read_wav(str(out / f"{name}_{stem}.wav"))[0]
                     * 32768).astype(np.int32)
            for stem in ("Instruments", "Vocals")]


def _run(main, ckpt, song, out, *flags):
    main(["-P", ckpt, "-i", song, "-r", str(SR), "-f", str(N_FFT), "-H",
          str(HOP), "-B", "2", "-o", str(out), *flags])
    return _stems(out)


@pytest.fixture
def song(tmp_path):
    path = str(tmp_path / "song.wav")
    audio.write_wav(path, synth_song(SR, 3.3), SR)
    return path


@pytest.mark.parametrize("flags", [["--postprocess"], ["--output_image"],
                                   ["--tta", "--postprocess"]],
                         ids=["postprocess", "output_image", "tta_postprocess"])
def test_cli_spectrogram_path_matches_jax(ckpt, song, tmp_path, capsys, flags):
    """The spectrogram path's stems (natural iSTFT length) within 1 LSB of
    the JAX CLI's, its stage lines, and the images equal."""
    ref = _run(jcli.main, ckpt, song, tmp_path / "jax", *flags)
    capsys.readouterr()
    got = _run(cli.main, ckpt, song, tmp_path / "port", "--gpu", "-1", *flags)
    said = capsys.readouterr().out
    for stage in ("stft", "separate", "istft + write instruments",
                  "istft + write vocals"):
        assert f"  {stage}: " in said
    n = HOP * (int(SR * 3.3) // HOP)
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (2, n) and max_lsb(a, b) <= 1
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    if "--output_image" in flags:
        ext = ".jpg" if importlib.util.find_spec("PIL") else ".png"
        assert [f for f in names if f.endswith(ext)] == [
            f"song_Instruments{ext}", f"song_Vocals{ext}"]
        for f in names:
            assert ((tmp_path / "port" / f).read_bytes()
                    == (tmp_path / "jax" / f).read_bytes()) or f.endswith(".wav")


@pytest.mark.parametrize("tta", [False, True])
def test_cli_postprocess_matches_streamed_postprocess(ckpt, song, tmp_path,
                                                      tta):
    """`--postprocess` (spectrogram path) against `--stream --postprocess`
    on the same song: JAX's bound between the two, in LSB, on the
    samples both write."""
    flags = ["--gpu", "-1", "--postprocess"] + (["--tta"] if tta else [])
    mono = _run(cli.main, ckpt, song, tmp_path / "mono", *flags)
    stream = _run(cli.main, ckpt, song, tmp_path / "stream", "--stream",
                  *flags)
    for a, b in zip(mono, stream):
        assert max_lsb(a, b[:, :a.shape[1]]) <= STREAM_POSTPROCESS_LSB


def test_cli_complex_checkpoint_takes_the_spectrogram_path(pairs, song,
                                                           tmp_path, capsys):
    """A complex checkpoint never streams: with --stream --postprocess it
    takes the spectrogram path, as the JAX CLI does, and writes its
    stems within 1 LSB."""
    _, v, tmod = pairs["complex"]
    path = str(tmp_path / "complex.vrt.npz")
    convert.save_native(path, v, convert.model_config(tmod))
    ref = _run(jcli.main, path, song, tmp_path / "jax", "--stream",
               "--postprocess")
    capsys.readouterr()
    got = _run(cli.main, path, song, tmp_path / "port", "--stream",
               "--postprocess", "--gpu", "-1")
    assert "  stft: " in capsys.readouterr().out
    for a, b in zip(got, ref):
        assert a.shape == b.shape and max_lsb(a, b) <= 1


def test_pth_from_jax_export_loads_strictly(pairs, tmp_path):
    """A `.pth` written by the JAX package's `export_torch` loads strictly
    into the port (every key, no extra), holds the same weights, and
    separates within 1 LSB of JAX's `load_model` on that file."""
    jmod, v, tmod = pairs["magnitude"]
    pth = str(tmp_path / "small.pth")
    jconvert.export_torch(pth, jmod, v)
    model = convert.load_model(pth, N_FFT, HOP, 8, 16)
    for k, t in tmod.state_dict().items():
        assert torch.equal(model.state_dict()[k], t), k
    jm, jv = jconvert.load_model(pth, N_FFT, HOP, 8, 16)
    wave = synth_song(SR, 3.3)
    ours = Separator(model, batchsize=2, device="cpu").separate_wave(
        wave, pcm16_io=True)
    theirs = JSeparator(jm, jv, batchsize=2).separate_wave(wave,
                                                           pcm16_io=True)
    for a, b in zip(ours, theirs):
        assert max_lsb(a, b) <= 1
    sd = torch.load(pth, weights_only=True)
    sd["extra.weight"] = torch.zeros(1)
    torch.save(sd, pth)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        convert.load_model(pth, N_FFT, HOP, 8, 16)


def test_cli_takes_pth(song, tmp_path):
    """`-P model.pth` (the CLI's CascadedNet(n_fft, hop, 32, 128)) writes
    the stems of the same weights as `.vrt.npz`, bit for bit."""
    model = CascadedNet(N_FFT, HOP, 32, 128,
                        generator=torch.Generator().manual_seed(3))
    npz, pth = str(tmp_path / "m.vrt.npz"), str(tmp_path / "m.pth")
    convert.save_native(npz, convert.to_jax_variables(model),
                        convert.model_config(model))
    torch.save(model.state_dict(), pth)
    a = _run(cli.main, npz, song, tmp_path / "npz", "--gpu", "-1",
             "--postprocess")
    b = _run(cli.main, pth, song, tmp_path / "pth", "--gpu", "-1",
             "--postprocess")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["single", "directory"])
def test_cli_profile_writes_a_trace(ckpt, song, tmp_path, mode):
    trace = tmp_path / "trace"
    src = ["-i", song] if mode == "single" else [
        "--input_dir", os.path.dirname(song), "-c", "256", "-B", "2"]
    cli.main(["-P", ckpt, *src, "-r", str(SR), "-f", str(N_FFT), "-H",
              str(HOP), "-o", str(tmp_path / "out"), "--gpu", "-1",
              "--profile", str(trace)])
    (path,) = trace.iterdir()
    assert path.name.endswith(".json") and path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "separation" for e in events)
    if mode == "single":  # the directory's model runs on worker threads
        assert any("conv" in e.get("name", "") for e in events)
    assert (tmp_path / "out" / "song_Instruments.wav").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("tta", [False, True])
def test_separate_on_card_matches_cpu(pairs, tta):
    """On the card in `highest`: the spectrogram API's stems within 1 LSB
    of the port's on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tmod = pairs["magnitude"][2]
    wave = synth_song(SR, 7.3)
    X = tstft.stft_np(wave, N_FFT, HOP)
    stems = []
    for device in ("cuda", "cpu"):
        sp = Separator(tmod, batchsize=2, device=device, postprocess=True)
        specs = sp.separate_tta(X) if tta else sp.separate(X)
        stems.append([audio.pcm16_encode(tstft.istft_np(s, N_FFT, HOP))
                      for s in specs])
    for a, b in zip(*stems):
        assert max_lsb(a, b) <= 1
