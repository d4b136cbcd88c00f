"""Checkpoint I/O: the native `.vrt.npz` format, the reference's `.pth`
state_dicts and the JAX variables tree.

Counterpart of vocal_remover_tpu/models/convert.py. A `.vrt.npz` holds
the JAX package's variables tree flattened to '/'-joined keys (HWIO conv
kernels, (in, out) dense and LSTM weights, BN scale/bias/mean/var) plus
a JSON config record; `save_native(..., quantize="int8")` stores the
kernels as int8 with per-output-channel scales (`.q8` / `.q8scale`),
which `load_native` dequantizes.
`from_jax_variables` / `to_jax_variables` translate between that tree
and the port's modules, whose state_dict keys are the reference's.
`to_jax_variables` also reads a serving-transformed module
(models/serving.py) back as the JAX package's transformed tree: folded
conv kernels, identity-BN shifts, `<band net>/flat_enc/<layer>/wst`
and `bias`, and int8 convs as `<...>/conv/{q, scale[, a_scale]}`, which
`from_jax_variables` takes too (a tree the JAX package quantized runs in
the port); `weight_dtypes` gives each leaf's resident dtype.
`load_checkpoint` loads either format into a model and `export_torch`
writes one as a `.pth` (cli/convert.py).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

_CONFIG_KEY = "__config__"
_Q8_SUFFIX = ".q8"
_Q8_SCALE_SUFFIX = ".q8scale"


def _flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _quantize_leaf_q8(w: np.ndarray):
    """Per-output-channel symmetric int8: q = round(w / scale), scale =
    absmax / 127 over all axes but the last (HWIO conv kernels and (in,
    out) dense kernels both keep output channels last); the JAX
    package's operations, so the arrays are its own."""
    w = np.asarray(w, np.float32)
    absmax = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def save_native(path: str, variables, config: dict | None = None,
                quantize: str | None = None):
    """Atomically write a variables tree (+ model config) as a flat npz.
    quantize="int8" stores every float leaf of two or more dimensions
    (conv / dense / LSTM kernels) as `<key>.q8` int8 + `<key>.q8scale`
    float32 (about 4x smaller); 1-D leaves stay float32."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    flat = _flatten(variables)
    if quantize == "int8":
        for k in list(flat):
            v = flat[k]
            if v.ndim >= 2 and np.issubdtype(v.dtype, np.floating):
                del flat[k]
                flat[k + _Q8_SUFFIX], flat[k + _Q8_SCALE_SUFFIX] = \
                    _quantize_leaf_q8(v)
    flat[_CONFIG_KEY] = np.frombuffer(json.dumps(config or {}).encode(),
                                      dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_native(path: str):
    """-> (variables tree of numpy arrays, config dict). int8-quantized
    leaves are dequantized to float32."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != _CONFIG_KEY}
        config = (json.loads(bytes(z[_CONFIG_KEY]).decode())
                  if _CONFIG_KEY in z.files else {})
    for k in [k for k in flat if k.endswith(_Q8_SUFFIX)]:
        base = k[: -len(_Q8_SUFFIX)]
        scale = flat.pop(base + _Q8_SCALE_SUFFIX)
        flat[base] = flat.pop(k).astype(np.float32) * scale
    return _unflatten(flat), config


# JAX tree paths <-> torch state_dict keys. The low-band squeezes are the
# second half of the reference's Sequential low nets, and ASPP's pooled
# branch is conv1.1 (after its AdaptiveAvgPool2d).
_TOP = {
    "stg1_low_band_net": ["stg1_low_band_net", "0"],
    "stg1_low_squeeze": ["stg1_low_band_net", "1"],
    "stg2_low_band_net": ["stg2_low_band_net", "0"],
    "stg2_low_squeeze": ["stg2_low_band_net", "1"],
}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_DENSE = {"w": "weight", "b": "bias"}
_LSTM = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
         "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0"}
_DIR = {"fwd": "", "bwd": "_reverse"}
_TOP_INV = {tuple(v): k for k, v in _TOP.items()}
_Q8_LEAVES = ("q", "scale", "a_scale")  # an int8 conv's leaves
_BN_INV, _DENSE_INV, _LSTM_INV, _DIR_INV = (
    {v: k for k, v in d.items()} for d in (_BN, _DENSE, _LSTM, _DIR))


def _torch_key(path: tuple[str, ...]) -> str:
    """JAX variables path -> torch state_dict key."""
    if path[0] in ("out", "aux_out"):  # {"conv": (1, 1, I, O)} plain 1x1
        return f"{path[0]}.weight"
    p = [m for name in _TOP.get(path[0], [path[0]]) + list(path[1:])
         for m in (["conv1", "1"] if name == "pooled_conv" else [name])]
    if p[-1] == "conv":
        return ".".join(p + ["0", "weight"])
    if p[-2] == "conv" and p[-1] in _Q8_LEAVES:
        return ".".join(p[:-1] + ["0", p[-1]])
    if p[-2] == "bn":
        return ".".join(p[:-2] + ["conv", "1", _BN[p[-1]]])
    if p[-2] == "dense_bn":
        return ".".join(p[:-2] + ["dense", "1", _BN[p[-1]]])
    if p[-2] == "dense":
        return ".".join(p[:-2] + ["dense", "0", _DENSE[p[-1]]])
    if p[-3] == "lstm":
        return ".".join(p[:-2] + [_LSTM[p[-1]] + _DIR[p[-2]]])
    raise KeyError("/".join(path))


def _jax_path(key: str) -> tuple[str, ...] | None:
    """torch state_dict key -> JAX variables path (None for
    num_batches_tracked, which the JAX tree does not keep)."""
    k = key.split(".")
    if k[-1] == "num_batches_tracked":
        return None
    if k[0] in ("out", "aux_out"):
        return (k[0], "conv")
    top = _TOP_INV.get(tuple(k[:2]))
    p = [top, *k[2:]] if top else list(k)
    if "flat_enc" in p:  # <net>.flat_enc.<layer>.{wst,bias}, as it is
        return tuple(p)
    for i in range(len(p) - 1):  # only ASPP has a conv1 with a child "1"
        if p[i:i + 2] == ["conv1", "1"]:
            p[i:i + 2] = ["pooled_conv"]
            break
    if p[-3:-1] == ["conv", "0"]:
        return tuple(p[:-2] + ([p[-1]] if p[-1] in _Q8_LEAVES else []))
    if p[-3:-1] == ["conv", "1"]:
        return tuple(p[:-3] + ["bn", _BN_INV[p[-1]]])
    if p[-3:-1] == ["dense", "1"]:
        return tuple(p[:-3] + ["dense_bn", _BN_INV[p[-1]]])
    if p[-3:-1] == ["dense", "0"]:
        return tuple(p[:-3] + ["dense", _DENSE_INV[p[-1]]])
    if p[-2] == "lstm":
        sfx = "_reverse" if p[-1].endswith("_reverse") else ""
        name = p[-1][: len(p[-1]) - len(sfx)]
        return tuple(p[:-1] + [_DIR_INV[sfx], _LSTM_INV[name]])
    raise KeyError(key)


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    return a.T if a.ndim == 2 else a  # (in, out) -> (out, in)


def _to_jax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    return a.T if a.ndim == 2 else a


def module_path(name: str) -> tuple[str, ...]:
    """The JAX tree path of the kernel leaf of the conv module `name`
    (`<...>.conv.0`, a Conv2d or QConv2d)."""
    return _jax_path(name + ".weight")


def _load_int8_convs(model: torch.nn.Module, flat: dict):
    """Put a QConv2d in place of every Conv2d whose JAX leaf is an int8
    {q, scale[, a_scale]} dict (JAX `quantize_int8`); its buffers are
    filled by the state dict load."""
    from vocal_remover_tpu_torch.nn.layers import QConv2d

    paths = sorted(p[:-2] for p in flat if p.endswith("/q"))
    for path in paths:
        name = _torch_key(tuple(path.split("/")))[: -len(".weight")]
        parent, idx = name.rsplit(".", 1)
        seq = model.get_submodule(parent)
        conv = seq[int(idx)]
        q = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(
            np.asarray(flat[path + "/q"]))))
        a_scale = torch.zeros(()) if path + "/a_scale" in flat else None
        seq[int(idx)] = QConv2d(q, torch.zeros(q.shape[0]), a_scale,
                                conv.stride, conv.pad, conv.dilation)
    if paths:
        model.serving_transformed = True


def from_jax_variables(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a JAX variables tree (numpy leaves, as `load_native` returns
    and the JAX `CascadedNet.init` makes) into `model`, in place. int8
    convs of a quantized tree replace the model's Conv2d modules and keep
    their int8 values."""
    flat = _flatten(tree)
    _load_int8_convs(model, flat)
    state = {
        _torch_key(tuple(path.split("/"))): torch.from_numpy(
            np.ascontiguousarray(_to_torch_layout(np.asarray(
                v, np.int8 if path.endswith("/q") else np.float32))))
        for path, v in flat.items()
    }
    want = {k for k in model.state_dict() if _jax_path(k) is not None}
    if set(state) != want:
        missing, extra = sorted(want - set(state)), sorted(set(state) - want)
        raise ValueError(f"variables do not match the model: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    model.load_state_dict(state, strict=False)
    return model


def to_jax_variables(model: torch.nn.Module):
    """The module's weights as a JAX variables tree of numpy arrays
    (inverse of `from_jax_variables`). bf16-resident leaves come back
    as float32 arrays of the same values (numpy has no bfloat16);
    `weight_dtypes` tells which they are."""
    flat = {}
    for key, v in model.state_dict().items():
        path = _jax_path(key)
        if path is not None:
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                v = v.float()
            flat["/".join(path)] = np.ascontiguousarray(
                _to_jax_layout(v.numpy()))
    return _unflatten(flat)


def weight_dtypes(model: torch.nn.Module) -> dict[str, str]:
    """'/'-joined JAX tree path -> resident dtype name ('float32',
    'bfloat16') of every leaf of `to_jax_variables(model)`."""
    return {"/".join(path): str(v.dtype).replace("torch.", "")
            for key, v in model.state_dict().items()
            if (path := _jax_path(key)) is not None}


def model_config(model) -> dict:
    return {
        "n_fft": model.n_fft,
        "hop_length": model.hop_length,
        "nout": model.nout,
        "nout_lstm": model.nout_lstm,
        "is_complex": model.is_complex,
        "arch": "CascadedNet",
    }


def load_model(path: str, n_fft: int, hop_length: int, nout: int = 32,
               nout_lstm: int = 128):
    """Build a CascadedNet (on the CPU) from a checkpoint: a native
    `.vrt.npz`, whose embedded config wins over the arguments, or a
    reference torch `.pth` state_dict, loaded strictly into
    CascadedNet(n_fft, hop_length, nout, nout_lstm)."""
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet

    if path.endswith(".vrtx"):
        raise ValueError(
            f"{path!r} is a serving artifact, not a checkpoint: load it "
            "with vocal_remover_tpu_torch.separate.artifact.load_artifact"
        )
    if not path.endswith(".npz"):
        return load_checkpoint(path, CascadedNet(n_fft, hop_length, nout,
                                                 nout_lstm))
    variables, config = load_native(path)
    model = CascadedNet(
        config.get("n_fft", n_fft),
        config.get("hop_length", hop_length),
        config.get("nout") or nout,
        config.get("nout_lstm") or nout_lstm,
        bool(config.get("is_complex", False)),
    )
    return from_jax_variables(model, variables)


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a native `.npz` / `.vrt.npz` or a reference torch `.pth`
    checkpoint into `model`, in place (JAX `load_checkpoint`). A `.pth`
    loads strictly; a native file whose config disagrees with the model
    on is_complex, n_fft or nout is refused."""
    if not path.endswith(".npz"):
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        return model
    variables, config = load_native(path)
    for key in ("is_complex", "n_fft", "nout"):
        want, have = getattr(model, key, None), config.get(key)
        if have is not None and want is not None and have != want:
            raise ValueError(
                f"checkpoint {path!r} was trained with {key}={have} but the "
                f"model is configured with {key}={want} (pass the matching "
                "flags, e.g. --complex)")
    return from_jax_variables(model, variables)


def export_torch(path: str, model: torch.nn.Module):
    """Write the model's weights as a reference-compatible torch
    state_dict (CPU tensors, the reference's keys)."""
    torch.save({k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}, path)
