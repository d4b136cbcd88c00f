"""Build the port's native extension (audio decoders, host kernels) and
load it.

The C sources beside this file (decoders.c, the module; flacdec.c,
mp3dec.c, aacdec.c, sbrdec.c, the decoders; host.c, the training crops'
magnitudes, PCM16 and uint8 staging) are compiled by the C compiler (`$CC`,
else `cc` on PATH) at first use into one CPython extension in
`build/torch_native/` at the root of the checkout (listed in
.gitignore). Its name carries a hash of the sources, headers, flags,
compiler and host name (`-march=native` code is for the machine that
built it, and a copied checkout may carry the build directory), so an
edited source is rebuilt and an unchanged one reused. A failed build
raises with the compiler's output.

    python -m vocal_remover_tpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import platform
import shutil
import subprocess
import sysconfig
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
SOURCES = ("decoders.c", "flacdec.c", "mp3dec.c", "aacdec.c", "sbrdec.c",
           "host.c")
HEADERS = ("sbrdec.h", "sbr_tables.h")
MODULE = "_vrtnative_torch"
# the JAX package's flags: the same code generation, the same samples and
# magnitudes
CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_mod = None


def compiler() -> str:
    """The C compiler: $CC, else `cc` on PATH."""
    cc = os.environ.get("CC") or shutil.which("cc")
    if not cc:
        raise RuntimeError("no C compiler: set CC or put cc on PATH to "
                           "build the native extension")
    return cc


def build() -> Path:
    """Compile the extension (if not built yet); -> its path."""
    cc = compiler()
    include = sysconfig.get_paths()["include"]
    digest = hashlib.sha256(" ".join(
        (cc, include, platform.node(), platform.machine(), *CFLAGS)).encode())
    for name in SOURCES + HEADERS:
        digest.update((SRC_DIR / name).read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = BUILD_DIR / f"{MODULE}-{digest.hexdigest()[:16]}{suffix}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [cc, *CFLAGS, "-o", tmp, *(str(SRC_DIR / s) for s in SOURCES),
             f"-I{include}", "-lm"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cc} failed building the native extension "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load():
    """Build (once) and import the extension; cached per process."""
    global _mod
    if _mod is None:
        path = str(build())
        loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
        spec = importlib.util.spec_from_file_location(MODULE, path,
                                                      loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _mod = mod
    return _mod


if __name__ == "__main__":
    print(build())
