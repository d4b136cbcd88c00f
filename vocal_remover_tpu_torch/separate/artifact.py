"""AOT serving artifacts: the model's hot call exported with torch.export.

Counterpart of vocal_remover_tpu/separate/artifact.py. The patch->mask
call `model(x)`, x (batch, C, output_bin, crop) float32, is exported
once per crop width with `torch.export`, after the serving transform
(eval-BN fold, optional bf16 weights; never the flat-conv packing, as in
the JAX package), with the weights baked in and the batch a
`torch.export.Dim`. The width is pinned per entry, for the JAX package's
reason: the decoders' align_corners interp matrices have static shapes.
A serving host needs only the file and the port (no checkpoint, no
model code of its own). `ArtifactModel` exposes what the serving stack
reads from a model (`n_fft`, `hop_length`, `offset`, `is_complex`,
`.to`, `.eval`, `__call__`), so `Separator`, `SeparatorService` and
`StreamingSeparator` take a loaded artifact as they take a model.

File format (`.vrtx`), the JAX package's zip layout:
  meta.json          geometry and provenance: the JAX package's keys
                     (`format_version`, `kind`, `model_config`, `offset`,
                     `output_bin`, `channels`, `cropsizes`,
                     `serving_transform`, `weights_dtype`), and
                     `"format": "torch.export"`, `torch_version`,
                     `platforms` (the device type traced on) and
                     `precision` (the mode whose process switches the
                     call needs: TF32 on for `default`, off otherwise)
  exported_<W>.pt2   `torch.export.save` of the call at crop width W,
                     stored uncompressed

The programs are saved with their weights on the CPU, whatever device
they were traced on; `ArtifactModel.to` moves them with
`torch.export.passes.move_to_device_pass`, so one file serves on the
card and on the CPU. The BiLSTM recurrence is the custom op
`vocal_remover_tpu_torch::lstm_recurrence` (nn/lstm_kernel.py), which
must be registered before `torch.export.load`: `load_artifact` imports
it first. A `.pt2` is read by the torch release that wrote it
(`torch_version`); no other is promised. A JAX-made `.vrtx` (StableHLO
entries `exported_<W>.bin`) needs jax and is refused.
"""

from __future__ import annotations

import copy
import io
import json
import os
import zipfile

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from vocal_remover_tpu_torch import resolve_device
from vocal_remover_tpu_torch.nn import config

FORMAT_VERSION = 1
FORMAT = "torch.export"
DEFAULT_CROPSIZES = (256, 1024)
# the example batch of the trace; batch 1 would pin the batch to 1
_TRACE_BATCH = 2
_BAKED_IN = ("an artifact's dtypes are baked in at export; it moves only "
             "with .to(device)")


def export_artifact(model: nn.Module, path: str, *, device=None,
                    serving_transform: bool = True, dtype=None,
                    cropsizes=DEFAULT_CROPSIZES, precision=None) -> dict:
    """Export `model(x)` (x: (batch, C, output_bin, crop) float32) to
    `path`, once per crop width in `cropsizes`; -> the file's meta.

    `model` is the port's CascadedNet, left as it is: the export runs on
    a copy, after `serving.serving_variables(model, dtype)` (BN fold,
    weights cast to `dtype`) unless `serving_transform=False`. The trace
    runs on `device` (default `cuda`; raises without a card unless the
    CPU is asked for) under `precision` (default the current mode,
    nn/config.py), which bakes in the compute dtype; the mode's TF32
    switches are recorded in meta and set by `ArtifactModel` at call
    time."""
    from vocal_remover_tpu_torch.models import convert

    cropsizes = sorted({int(c) for c in cropsizes})
    if not cropsizes:
        raise ValueError("need at least one cropsize")
    for crop in cropsizes:
        if crop <= 2 * model.offset:
            raise ValueError(
                f"cropsize {crop} leaves no roi (offset {model.offset})")
    precision = precision or config.get_precision()
    device = resolve_device(device)
    if serving_transform:
        from vocal_remover_tpu_torch.models import serving

        served = serving.serving_variables(model, dtype)
    else:
        served = copy.deepcopy(model).eval()
    served = served.to(device)
    channels = 4 if model.is_complex else 2

    blobs = {}
    batch = torch.export.Dim("batch", min=1)
    with config.precision(precision):
        for crop in cropsizes:
            x = torch.zeros(_TRACE_BATCH, channels, model.output_bin, crop,
                            device=device)
            ep = torch.export.export(served, (x,),
                                     dynamic_shapes=({0: batch},),
                                     strict=False)
            if device.type != "cpu":
                ep = move_to_device_pass(ep, "cpu")
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            blobs[crop] = buf.getvalue()

    meta = {
        "format_version": FORMAT_VERSION,
        "format": FORMAT,
        "kind": "patch_mask",
        "model_config": convert.model_config(model),
        "offset": int(model.offset),
        "output_bin": int(model.output_bin),
        "channels": channels,
        "cropsizes": cropsizes,
        "serving_transform": bool(serving_transform),
        "weights_dtype": str(dtype or "float32").replace("torch.", ""),
        "platforms": [device.type],
        "precision": precision,
        "torch_version": torch.__version__,
    }
    tmp = f"{path}.tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        for crop, blob in blobs.items():
            # the weights dominate and do not deflate: store them, so a
            # load is one read
            z.writestr(zipfile.ZipInfo(f"exported_{crop}.pt2"), blob,
                       compress_type=zipfile.ZIP_STORED)
    os.replace(tmp, path)
    return meta


class ArtifactModel(nn.Module):
    """A loaded artifact, shaped like a model for the serving stack.

    Holds one exported program per crop width, each deserialized at its
    first use (`program`): a run at one width does not pay for the
    others. The programs are not submodules: the exported graphs are
    eval-only and refuse `train` / `eval`, so `eval()` is a no-op here
    and `train(True)` raises. `.to` takes a device only; a dtype cast is
    refused, since the numerics are baked in."""

    def __init__(self, blobs: dict, meta: dict):
        super().__init__()
        self._blobs = dict(blobs)  # crop -> torch.export.save bytes
        self._programs, self._calls = {}, {}
        self.device = torch.device("cpu")
        self.meta = meta
        cfg = meta["model_config"]
        self.n_fft = int(cfg["n_fft"])
        self.hop_length = int(cfg["hop_length"])
        self.is_complex = bool(cfg.get("is_complex", False))
        self.offset = int(meta["offset"])
        self.output_bin = int(meta["output_bin"])
        self.channels = int(meta["channels"])
        self.cropsizes = sorted(self._blobs)
        self.training = False

    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError(
                "an artifact is an exported eval-only graph; it cannot be "
                "put in train mode")
        return self

    def _apply(self, fn, recurse=True):
        raise TypeError(_BAKED_IN)

    def _hold(self, crop: int, ep):
        self._programs[crop], self._calls[crop] = ep, ep.module()

    def to(self, device):
        """Move every program to `device` (in place; -> self)."""
        if isinstance(device, torch.dtype):
            raise TypeError(_BAKED_IN)
        device = torch.device(device)
        if str(device) != str(self.device):
            self.device = device
            for crop, ep in list(self._programs.items()):
                self._hold(crop, move_to_device_pass(ep, str(device)))
        return self

    def program(self, crop: int):
        """The exported program of width `crop` on the artifact's device,
        deserialized at its first use."""
        if crop not in self._programs:
            if crop not in self._blobs:
                raise ValueError(
                    f"artifact has no entry for cropsize {crop} (carries "
                    f"{self.cropsizes}); re-export with --cropsizes "
                    f"including {crop}")
            ep = torch.export.load(io.BytesIO(self._blobs[crop]))
            if self.device.type != "cpu":  # saved on the CPU
                ep = move_to_device_pass(ep, str(self.device))
            self._hold(crop, ep)
        return self._programs[crop]

    def forward(self, x):
        if x.dim() != 4 or x.shape[1] != self.channels \
                or x.shape[2] != self.output_bin:
            raise ValueError(
                f"artifact expects (batch, {self.channels}, "
                f"{self.output_bin}, crop) patches, got {tuple(x.shape)}")
        crop = int(x.shape[3])
        self.program(crop)
        with config.precision(self.meta["precision"]):
            return self._calls[crop](x)


def load_artifact(path: str, device=None) -> ArtifactModel:
    """Read a `.vrtx` written by `export_artifact`, on the CPU unless
    `device` is given (`ArtifactModel.to` moves it). Each entry is
    deserialized at its first use."""
    # registers the recurrence op, which the programs call, before any
    # torch.export.load
    from vocal_remover_tpu_torch.nn import lstm_kernel  # noqa: F401

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json").decode())
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"artifact {path} has format_version "
                f"{meta['format_version']}; this build reads <= "
                f"{FORMAT_VERSION}")
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"artifact {path} was written by the JAX package "
                "(StableHLO entries exported_<W>.bin): reading StableHLO "
                "needs jax, which the GPU port does not use; export the "
                "checkpoint again with python -m "
                "vocal_remover_tpu_torch.cli.export")
        blobs = {int(crop): z.read(f"exported_{crop}.pt2")
                 for crop in meta["cropsizes"]}
    model = ArtifactModel(blobs, meta)
    return model if device is None else model.to(resolve_device(device))


def artifact_separator(path: str, *, batchsize: int = 4, cropsize=None,
                       postprocess: bool = False, device=None):
    """Load an artifact and wrap it in a ready `Separator` (on `device`,
    default `cuda`), at the artifact's precision."""
    from vocal_remover_tpu_torch.separate.separator import Separator

    am = load_artifact(path)
    if cropsize is None:
        cropsize = am.cropsizes[0]
    return Separator(am, batchsize=batchsize, cropsize=cropsize,
                     device=device, precision=am.meta["precision"],
                     postprocess=postprocess)
