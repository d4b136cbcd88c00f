"""The JAX package's training state (`train_state.msgpack`) without flax.

vocal_remover_tpu/train/checkpoint.py writes `flax.serialization.
to_bytes({"params", "stats", "opt_state"})`: msgpack of nested maps with
numpy leaves as flax's extension types. This module carries its own
msgpack reader and writer (pure Python and numpy, as msgpack-python
packs with `use_bin_type=True`) and maps that state onto a `Trainer`:

  * `params` and `stats` (the BN running mean / var) go through
    `convert.from_jax_variables` (HWIO -> OIHW, (in, out) -> (out, in));
  * the state of `optax.inject_hyperparams(optax.adam)`: `{"count",
    "hyperparams": {"b1", "b2", "eps", "eps_root", "learning_rate"},
    "hyperparams_states": {}, "inner_state": {"0": {"count", "mu",
    "nu"}, "1": {}}}`; `mu` / `nu` take the parameters' path and layout
    into Adam's `exp_avg` / `exp_avg_sq`, the inner `count` becomes each
    parameter's `step`, `learning_rate` the param groups' `lr`.

The extension types are flax's: 1, an ndarray packed as (shape, dtype
name, C-order bytes); 2, a Python complex as (real, imag); 3, a numpy
scalar as a 0-d ndarray. Arrays over MAX_CHUNK_SIZE bytes are written,
and read, as flax's `__msgpack_chunked_array__` maps. numpy has no
bfloat16: a bfloat16 leaf is read as float32 of the same values.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from vocal_remover_tpu_torch.models import convert

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------------
# msgpack
# ----------------------------------------------------------------------

# msgpack type bytes past the fix forms
_CONSTANTS = {0xc0: None, 0xc2: False, 0xc3: True}
_NUMBERS = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I", 0xcf: "Q",
            0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
_SIZED = {0xc4: ("bin", "B"), 0xc5: ("bin", "H"), 0xc6: ("bin", "I"),
          0xd9: ("str", "B"), 0xda: ("str", "H"), 0xdb: ("str", "I"),
          0xc7: ("ext", "B"), 0xc8: ("ext", "H"), 0xc9: ("ext", "I"),
          0xdc: ("array", "H"), 0xdd: ("array", "I"),
          0xde: ("map", "H"), 0xdf: ("map", "I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _pack_len(out, n, fix, fix_max, codes):
    """A length header: the fix form below `fix_max`, else the 8 / 16 /
    32-bit form in `codes` (None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
    elif codes[0] is not None and n < 2**8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 2**16:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_int(out, v):
    if 0 <= v < 0x80 or -32 <= v < 0:
        out.append(struct.pack("b" if v < 0 else "B", v))
        return
    forms = ((0xcc, "B", 0, 2**8), (0xcd, "H", 0, 2**16),
             (0xce, "I", 0, 2**32), (0xcf, "Q", 0, 2**64),
             (0xd0, "b", -2**7, 0), (0xd1, "h", -2**15, 0),
             (0xd2, "i", -2**31, 0), (0xd3, "q", -2**63, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v < hi:
            out.append(struct.pack(">B" + fmt, code, v))
            return
    raise OverflowError(f"integer {v} does not fit msgpack")


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(out, obj):
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif t in (list, tuple):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _pack_len(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif t is complex:
        _pack_ext(out, EXT_COMPLEX, packb([obj.real, obj.imag]))
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def _pack_ext(out, code, data):
    fixed = {n: c for c, n in _FIXEXT.items()}
    if len(data) in fixed:
        out.append(struct.pack("B", fixed[len(data)]))
    else:
        _pack_len(out, len(data), None, 0, (0xc7, 0xc8, 0xc9))
    out.append(struct.pack("b", code))
    out.append(data)


def packb(obj) -> bytes:
    """msgpack bytes of `obj` (maps, lists, str, bytes, int, float, bool,
    None; ndarrays, numpy scalars and complex as flax's extensions)."""
    out: list[bytes] = []
    _pack(out, obj)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt,
                             self.take(struct.calcsize(">" + fmt)))[0]

    def value(self):
        c = self.unpack("B")
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if c < 0x90:
            return self.map(c & 0x0f)
        if c < 0xa0:
            return self.array(c & 0x0f)
        if c < 0xc0:
            return str(self.take(c & 0x1f), "utf-8")
        if c in _CONSTANTS:
            return _CONSTANTS[c]
        if c in _NUMBERS:
            return self.unpack(_NUMBERS[c])
        if c in _SIZED:
            kind, fmt = _SIZED[c]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "ext":
                return self.ext(n)
            return self.array(n) if kind == "array" else self.map(n)
        if c in _FIXEXT:
            return self.ext(_FIXEXT[c])
        raise ValueError(f"msgpack type byte {c:#x} is not supported")

    def bin_view(self) -> memoryview:
        """A bin's bytes, not copied."""
        c = self.unpack("B")
        if _SIZED.get(c, ("",))[0] != "bin":
            raise ValueError(f"expected msgpack bin, got type byte {c:#x}")
        return self.take(self.unpack(_SIZED[c][1]))

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n):
        code = self.unpack("b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"msgpack extension type {code} is not supported")


def _ndarray(data) -> np.ndarray:
    """flax's (shape, dtype name, bytes) triple -> a writable array."""
    r = _Reader(data)
    if r.unpack("B") != 0x93:
        raise ValueError("an ndarray extension holds a 3-element array")
    shape, name, buf = r.value(), r.value(), r.bin_view()
    if name == "bfloat16":  # numpy has none: widen exactly to float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def unpackb(data: bytes):
    """Inverse of `packb` (flax's extension hook included)."""
    r = _Reader(data)
    obj = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def _chunked(tree):
    """Arrays over MAX_CHUNK_SIZE bytes as flax's chunk maps, in a copy
    of the map tree (flax `_chunk_array_leaves_in_place`)."""
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {_CHUNKED: True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def _unchunked(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunked(v) for k, v in tree.items()}
    return tree


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize of a tree of maps."""
    return packb(_chunked(tree))


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore."""
    return _unchunked(unpackb(data))


# ----------------------------------------------------------------------
# the train state
# ----------------------------------------------------------------------

def _merge(params, stats):
    """The variables tree from its trainable and BN-statistics halves
    (JAX nn/partition.merge)."""
    out = dict(stats)
    for k, v in params.items():
        out[k] = _merge(v, out[k]) if isinstance(v, dict) and k in out else v
    return out


def _to_torch(tree):
    """{parameter name: tensor} of a tree shaped like `params`."""
    return {convert._torch_key(tuple(path.split("/"))): torch.from_numpy(
        np.ascontiguousarray(convert._to_torch_layout(a)))
        for path, a in convert._flatten(tree).items()}


def _adam(trainer):
    """optax.adam's hyperparameters of the trainer's torch.optim.Adam
    (which has no eps_root: 0)."""
    group = trainer.optimizer.param_groups[0]
    b1, b2 = group["betas"]
    return {"b1": b1, "b2": b2, "eps": group["eps"], "eps_root": 0.0}


def load(trainer, data: bytes):
    """Restore the model's parameters and BN statistics and Adam's
    state from a JAX train state's bytes into `trainer`, in place."""
    state = msgpack_restore(data)
    opt = state["opt_state"]
    for k, want in _adam(trainer).items():
        got = float(opt["hyperparams"][k])
        if got != float(np.float32(want)):
            raise ValueError(f"the state's Adam {k} is {got}; the "
                             f"Trainer's is {want}")
    convert.from_jax_variables(trainer.model,
                               _merge(state["params"], state["stats"]))
    adam = opt["inner_state"]["0"]
    mu, nu = _to_torch(adam["mu"]), _to_torch(adam["nu"])
    step = torch.tensor(float(adam["count"]), dtype=torch.float32)
    sd = trainer.optimizer.state_dict()
    names = [n for n, _ in trainer.model.named_parameters()]
    if set(names) != set(mu) or set(names) != set(nu):
        raise ValueError("the state's Adam moments do not match the model")
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    for group in sd["param_groups"]:
        group["lr"] = float(opt["hyperparams"]["learning_rate"])
    trainer.optimizer.load_state_dict(sd)


def state_bytes(trainer) -> bytes:
    """The trainer's state in the JAX package's layout: bytes that its
    `load_train_state` restores. A parameter Adam has not stepped yet
    (no gradient reached it) gets zero moments, as optax keeps them."""
    variables = convert.to_jax_variables(trainer.model)
    stats_keys = ("mean", "var")

    def split(tree, want_stats):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = split(v, want_stats)
                if sub:
                    out[k] = sub
            elif (k in stats_keys) == want_stats:
                out[k] = v
        return out

    mu, nu, step = {}, {}, 0
    for name, p in trainer.model.named_parameters():
        st = trainer.optimizer.state.get(p, {})
        path = "/".join(convert._jax_path(name))
        for flat, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            t = st.get(key, torch.zeros_like(p)).detach().cpu()
            flat[path] = np.ascontiguousarray(convert._to_jax_layout(
                (t.float() if t.dtype == torch.bfloat16 else t).numpy()))
        if "step" in st:
            step = max(step, int(st["step"]))
    count = np.asarray(step, np.int32)
    hyper = {k: np.asarray(v, np.float32)
             for k, v in _adam(trainer).items()}
    hyper["learning_rate"] = np.asarray(
        trainer.optimizer.param_groups[0]["lr"], np.float32)
    return msgpack_serialize({
        "params": split(variables, False),
        "stats": split(variables, True),
        "opt_state": {
            "count": count,
            "hyperparams": hyper,
            "hyperparams_states": {},
            "inner_state": {"0": {"count": count,
                                  "mu": convert._unflatten(mu),
                                  "nu": convert._unflatten(nu)},
                            "1": {}},
        },
    })
