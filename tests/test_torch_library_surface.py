"""GPU port: the public library surface against the JAX package's, by
parsing both packages' sources with `ast` (nothing is imported).

Every public function, class and method of the JAX package (names not
starting with "_", plus `__init__`, `__call__`, `__len__`, `__iter__`,
`__getitem__`) must exist in the port's module of the same path, with
every parameter name, and where both give a parameter a literal default,
the same default (a JAX or numpy dtype is compared by its name). A
method the port's class inherits from a base class of the port counts.
What the port leaves out on purpose is listed below with its reason; an
entry that no longer matches anything fails too, so the list stays
exact."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECIAL = ("__init__", "__call__", "__len__", "__iter__", "__getitem__")

FUNCTIONAL = ("the port's nn.Modules hold their own weights and buffers: "
              "JAX's functional init / apply / variables idiom has no "
              "counterpart (.pth loading is A1's convert)")
XLA = "an XLA or Pallas knob; the port has no such compiler switch"
OLD_KERNEL_MODULE = ("the JAX kernel's module; its counterpart lives in "
                     "the port's {}")
TENSORS = ("the port's functional form takes tensors and generators, not "
           "JAX's parameter dicts and keys")
MESH = ("a port mesh takes every rank of the world (torch.distributed) and "
        "shards modules in place: no device list, shardings or pytrees")
ARTIFACT = ("the port's artifact holds torch.export programs of a model "
            "that carries its weights")
NATIVE = ("the JAX package's extension is optional (get() returns None "
          "and callers fall back to numpy); the port's build raises "
          "instead, and builds at first use")

# (module path, qualified name, parameter or None for the whole name)
# -> why the port leaves it out
ALLOWED = {
    ("__init__.py", "enable_compile_cache", None):
        "JAX's persistent compilation cache; " + XLA,
    ("models/base_net.py", "BaseNet.init", None): FUNCTIONAL,
    ("models/base_net.py", "BaseNet.apply", None): FUNCTIONAL,
    ("models/base_net.py", "BaseNet.from_torch", None): FUNCTIONAL,
    ("models/base_net.py", "BaseNet.to_torch", None): FUNCTIONAL,
    ("models/cascaded.py", "CascadedNet.init", None): FUNCTIONAL,
    ("models/cascaded.py", "CascadedNet.apply", None): FUNCTIONAL,
    ("models/cascaded.py", "CascadedNet.__call__", None):
        FUNCTIONAL + "; nn.Module.__call__ is forward",
    ("models/cascaded.py", "CascadedNet.from_torch", None): FUNCTIONAL,
    ("models/cascaded.py", "CascadedNet.to_torch", None): FUNCTIONAL,
    ("models/cascaded.py", "CascadedNet.predict", "v"): FUNCTIONAL,
    ("models/cascaded.py", "CascadedNet.predict_mask", "v"): FUNCTIONAL,
    ("models/cascaded.py", "is_stat_leaf", None):
        "splits JAX's variables tree into parameters and statistics; "
        "the port's BatchNorm statistics are buffers",
    ("models/cascaded.py", "param_count", "variables"): FUNCTIONAL,
    ("models/convert.py", "export_torch", "variables"): FUNCTIONAL,
    ("models/serving.py", "calibrate_act_scales", "variables"): FUNCTIONAL,
    ("models/serving.py", "cast_weights", "variables"): FUNCTIONAL,
    ("models/serving.py", "fold_batch_norms", "variables"): FUNCTIONAL,
    ("models/serving.py", "pack_flat_encoders", "variables"): FUNCTIONAL,
    ("models/serving.py", "quantize_int8", "variables"): FUNCTIONAL,
    ("models/serving.py", "serving_variables", "variables"): FUNCTIONAL,
    ("native/__init__.py", "get", None): NATIVE,
    ("native/build.py", "ensure_built", None): NATIVE,
    ("native/build.py", "build", "verbose"):
        NATIVE + "; a failed build raises with the compiler's output",
    ("nn/config.py", "set_lstm_impl", None):
        XLA + " (the recurrence is the CUDA kernel; --lstm_impl is "
        "accepted and ignored)",
    ("nn/config.py", "get_lstm_impl", None): XLA,
    ("nn/conv_pack.py", "flat_conv", "m_target"): XLA,
    ("nn/conv_pack.py", "flat_conv", "interpret"): XLA,
    ("nn/conv_pack.py", "flat_layer_apply", "m_target"): XLA,
    ("nn/conv_pack.py", "flat_layer_apply", "interpret"): XLA,
    ("nn/conv_pallas.py", "fused_conv_chw", None):
        OLD_KERNEL_MODULE.format("nn/conv_chw.py fused_conv_chw"),
    ("nn/conv_pallas.py", "prepare_weights_s1", None):
        OLD_KERNEL_MODULE.format("nn/conv_chw.py"),
    ("nn/conv_pallas.py", "prepare_weights_s2", None):
        OLD_KERNEL_MODULE.format("nn/conv_chw.py"),
    ("nn/conv_pallas.py", "space_to_depth", None):
        OLD_KERNEL_MODULE.format("nn/conv_chw.py"),
    ("nn/lstm_pallas.py", "bilstm_pallas", None):
        OLD_KERNEL_MODULE.format("nn/lstm_kernel.py (the recurrence op)"),
    ("nn/functional.py", "batch_norm", "bn"): TENSORS,
    ("nn/functional.py", "batch_norm", "train"): TENSORS,
    ("nn/functional.py", "batch_norm", "axes"): TENSORS,
    ("nn/functional.py", "conv2d_int8", "w"): TENSORS,
    ("nn/functional.py", "dropout2d", "rng"): TENSORS,
    ("nn/init.py", "conv_kernel", None): FUNCTIONAL,
    ("nn/init.py", "linear_bias", None): FUNCTIONAL,
    ("nn/init.py", "linear_weight", None): FUNCTIONAL,
    ("nn/init.py", "lstm_param", None): FUNCTIONAL,
    ("nn/init.py", "uniform", None): FUNCTIONAL,
    ("nn/lstm.py", "init_bilstm", None): FUNCTIONAL,
    ("nn/lstm.py", "init_direction", None): FUNCTIONAL,
    ("nn/lstm.py", "bilstm", "unroll"): XLA,
    ("nn/partition.py", "partition", None): FUNCTIONAL,
    ("nn/partition.py", "merge", None): FUNCTIONAL,
    ("parallel/mesh.py", "make_mesh", "devices"): MESH,
    ("parallel/mesh.py", "batch_sharding", None): MESH,
    ("parallel/mesh.py", "replicated", None): MESH,
    ("parallel/policy.py", "shard_variables", "tree"): MESH,
    ("parallel/policy.py", "tp_partition_spec", "path"):
        MESH + "; it takes a state-dict name and tensor",
    ("parallel/policy.py", "tp_partition_spec", "leaf"):
        MESH + "; it takes a state-dict name and tensor",
    ("separate/artifact.py", "export_artifact", "variables"): ARTIFACT,
    ("separate/artifact.py", "export_artifact", "platforms"):
        ARTIFACT + "; the programs move between devices at load",
    ("separate/artifact.py", "ArtifactModel.__init__", "exported_by_crop"):
        ARTIFACT,
    ("separate/artifact.py", "ArtifactModel.init", None): ARTIFACT,
    ("separate/artifact.py", "ArtifactModel.__call__", None):
        ARTIFACT + "; nn.Module.__call__ is forward",
    ("separate/separator.py", "Separator.__init__", "variables"): FUNCTIONAL,
    ("separate/streaming.py", "StreamingSeparator.__init__", "variables"):
        FUNCTIONAL,
    ("train/checkpoint.py", "save_model", "trainer"):
        "the port's model holds its weights: save_model takes the model",
    ("train/step.py", "Trainer.__init__", "variables"): FUNCTIONAL,
    ("train/step.py", "Trainer.variables", None): FUNCTIONAL,
}
for _cls in ("ASPPModule", "Conv2DBNActiv", "Decoder", "Encoder",
             "LSTMModule"):
    for _m in ("init", "apply", "from_torch", "to_torch"):
        ALLOWED["nn/layers.py", f"{_cls}.{_m}", None] = FUNCTIONAL

# literal defaults that differ in spelling only, or on purpose
DEFAULTS_ALLOWED = {
    ("data/device_cache.py", "DeviceTrainingSource.__init__", "dtype"):
        "JAX's None means jnp.bfloat16 (device_cache.py), the port's "
        "default is torch.bfloat16",
    ("data/device_cache.py", "DeviceValidationSource.__init__", "dtype"):
        "as DeviceTrainingSource: JAX's None means jnp.bfloat16",
    ("models/serving.py", "serving_variables", "model"):
        "JAX's optional model (for calibration) beside its variables; "
        "the port's model is the module transformed, so it is required",
}


def _defaults(fn):
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {p.arg: ast.unparse(d)
           for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults)}
    out.update((p.arg, ast.unparse(d))
               for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None)
    return out


def _params(fn):
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def _public(name):
    return not name.startswith("_") or name in SPECIAL


def _surface(pkg):
    """{(module path, qualified name): (params, defaults) or None for a
    class}, and {class name: (module path, method names, base names)}."""
    root = os.path.join(ROOT, pkg)
    out, classes = {}, {}
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if not x.startswith(("_", ".")))
        for f in sorted(files):
            if not f.endswith(".py") or (f.startswith("_")
                                          and f != "__init__.py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), root)
            with open(os.path.join(d, f)) as fh:
                tree = ast.parse(fh.read(), rel)
            for node in tree.body:
                if isinstance(node, ast.FunctionDef) and _public(node.name):
                    out[rel, node.name] = (_params(node), _defaults(node))
                elif isinstance(node, ast.ClassDef) and _public(node.name):
                    out[rel, node.name] = None
                    methods = {}
                    for m in node.body:
                        if isinstance(m, ast.FunctionDef) and _public(m.name):
                            methods[m.name] = (_params(m), _defaults(m))
                            out[rel, f"{node.name}.{m.name}"] = methods[m.name]
                    bases = [ast.unparse(b).split(".")[-1] for b in node.bases]
                    classes[node.name] = (rel, methods, bases)
    return out, classes


def _lookup(surface, classes, rel, qual):
    """The port's entry for (module, name), a method found on a base
    class of the port included."""
    if (rel, qual) in surface:
        return surface[rel, qual]
    if "." not in qual:
        raise KeyError(qual)
    cls, meth = qual.split(".", 1)
    todo = list(classes[cls][2]) if cls in classes and \
        classes[cls][0] == rel else []
    while todo:
        base = todo.pop(0)
        if base in classes:
            _, methods, bases = classes[base]
            if meth in methods:
                return methods[meth]
            todo += bases
    raise KeyError(qual)


def _normal(default):
    for prefix in ("jnp.", "np.", "numpy.", "torch."):
        if default.startswith(prefix):
            return "dtype:" + default[len(prefix):]
    return default


@pytest.fixture(scope="module")
def surfaces():
    return _surface("vocal_remover_tpu"), _surface("vocal_remover_tpu_torch")


def _gaps(surfaces):
    """[(module, name, parameter or None, what)] of the JAX surface the
    port lacks."""
    (jax_surface, _), (port, classes) = surfaces
    gaps = []
    for (rel, qual), jsig in sorted(jax_surface.items()):
        try:
            sig = _lookup(port, classes, rel, qual)
        except KeyError:
            gaps.append((rel, qual, None, "missing"))
            continue
        if jsig is None:
            continue
        if sig is None:
            gaps.append((rel, qual, None, "a class in the port"))
            continue
        params, defaults = sig
        jparams, jdefaults = jsig
        for p in jparams:
            if p not in params:
                gaps.append((rel, qual, p, "missing keyword"))
            elif p in jdefaults and (p not in defaults or _normal(
                    defaults[p]) != _normal(jdefaults[p])):
                gaps.append((rel, qual, p, f"default {defaults.get(p)} "
                                           f"(JAX: {jdefaults[p]})"))
    return gaps


def test_port_has_the_jax_library_surface(surfaces):
    gaps = [g for g in _gaps(surfaces)
            if g[:3] not in ALLOWED and g[:3] not in DEFAULTS_ALLOWED]
    assert not gaps, "the port lacks:\n" + "\n".join(
        f"  {rel} {qual}" + (f"({p})" if p else "") + f": {what}"
        for rel, qual, p, what in gaps)


def test_allowlist_is_exact(surfaces):
    """Every allowed entry is a gap that exists, left out for its stated
    reason, and a default allowed to differ differs; a gap closed later
    must leave the list."""
    gaps = {g[:3]: g[3] for g in _gaps(surfaces)}
    stale = [k for k in ALLOWED if k not in gaps]
    assert not stale, f"allowed but not missing: {stale}"
    assert not [k for k in ALLOWED if gaps[k].startswith("default")]
    for k in DEFAULTS_ALLOWED:
        assert gaps.get(k, "").startswith("default"), k
    assert all(len(why) > 20 for why in {**ALLOWED,
                                         **DEFAULTS_ALLOWED}.values())


@pytest.mark.parametrize("rel,qual,param", [
    ("data/loader.py", "Loader.__init__", "epoch_multiplier"),
    ("data/loader.py", "Loader.__init__", "drop_last"),
    ("data/loader.py", "Loader.__init__", "prefetch"),
    ("data/loader.py", "Loader.num_samples", None),
    ("data/device_cache.py", "DeviceLoader.__init__", "drop_last"),
    ("data/device_cache.py", "DeviceLoader.__len__", None),
    ("data/dataset.py", "TrainingSet.__init__", "complex_as_channels"),
    ("data/dataset.py", "ValidationSet.__init__", "complex_as_channels"),
    ("data/cache.py", "make_training_set", "progress"),
    ("data/dataset.py", "make_validation_set", "progress"),
    ("train/step.py", "Trainer.__init__", "prefetch"),
    ("train/checkpoint.py", "save_train_state", "extra"),
    ("utils/audio.py", "load", "mono"),
    ("utils/audio.py", "load", "dtype"),
    ("utils/audio.py", "write_wav", "subtype"),
    ("utils/audio.py", "resample", "res_type"),
    ("utils/audio.py", "have_ffmpeg", None),
    ("utils/spec.py", "crop_center", "h2"),
    ("ops/stft.py", "istft_length", "hop_length"),
    ("ops/stft.py", "hann_window", "dtype"),
    ("ops/resize.py", "interp_taps", "n_out"),
    ("ops/resize.py", "resize_bilinear", "lerp2x"),
    ("ops/resize.py", "upsample2x", "lerp"),
    ("utils/image.py", "imread", "path"),
    ("native/__init__.py", "load_crop_abs", "coef"),
    ("native/__init__.py", "pcm16_encode", "wave"),
    ("native/__init__.py", "pcm16_decode", "pcm"),
    ("native/__init__.py", "quantize_u8", "a"),
])
def test_library_item_is_ported(surfaces, rel, qual, param):
    """The items of the last library slice, one by one: present in the
    port with JAX's name, keyword and default."""
    (jax_surface, jclasses), (port, classes) = surfaces
    jsig = _lookup(jax_surface, jclasses, rel, qual)
    sig = _lookup(port, classes, rel, qual)
    if param is not None:
        assert param in sig[0] and param in jsig[0]
        if param in jsig[1]:
            assert _normal(sig[1][param]) == _normal(jsig[1][param])
