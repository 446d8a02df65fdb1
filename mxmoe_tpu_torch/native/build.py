"""Build the native pack library from ``csrc/mxmoe_pack.cpp`` (port of
``mxmoe_tpu/native/build.py``): ``python -m mxmoe_tpu_torch.native.build``.

The library goes to ``mxmoe_tpu_torch/_build/`` under a name keyed by the
source and the flags, so an edited source builds anew; the loader in
``native/__init__.py`` calls :func:`build` at first use.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "..", "..", "csrc", "mxmoe_pack.cpp")
BUILD_DIR = os.path.join(HERE, "..", "_build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(" ".join(FLAGS).encode() + f.read())
    return os.path.abspath(os.path.join(BUILD_DIR,
                                        f"libmxmoe_pack_{h.hexdigest()[:16]}.so"))


def build(verbose: bool = False) -> str:
    """Compile the library unless this source and flag set has one already;
    returns its path. Raises when ``g++`` is missing or fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native: g++ not found on PATH; the pack library "
                           "(csrc/mxmoe_pack.cpp) cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        cmd = [cxx, *FLAGS, os.path.abspath(SOURCE), "-o", out]
        if verbose:
            print(" ".join(cmd))
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native: g++ failed ({res.returncode}):\n{res.stderr}")
        os.replace(out, path)      # atomic: a concurrent reader never sees half
    return path


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    from mxmoe_tpu_torch import native

    native.lib()
    print(f"built and loaded: {build()}")
