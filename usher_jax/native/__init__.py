"""Native host layer (C++): transpose-VCF codec and fast VCF ingest.

The extension is built from src/usher_native.cpp.  Build it ahead of time
with `python setup.py build_ext --inplace`; otherwise the first import
compiles it into this directory with the same flags as setup.py.  Falls back
to the pure-Python implementations when no C++ compiler, Python headers or
zlib are available.
"""

import os
import subprocess
import sys
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))


def _build() -> bool:
    """Compile the extension next to this file.  The library is written
    under a per-process name and renamed into place, so concurrent first
    imports never load a half-written file."""
    out = os.path.join(_HERE, "_usher_native"
                       + sysconfig.get_config_var("EXT_SUFFIX"))
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-DNDEBUG",
           "-shared", "-fPIC",
           "-I" + sysconfig.get_paths()["include"],
           os.path.join(_HERE, "src", "usher_native.cpp"), "-lz", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        print(f"usher_jax.native: build failed ({e}); using the pure-Python "
              f"host layer", file=sys.stderr)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


try:
    from . import _usher_native as ext  # type: ignore
except ImportError:
    ext = None
    if _build():
        try:
            from . import _usher_native as ext  # type: ignore
        except ImportError:
            ext = None

HAVE_NATIVE = ext is not None
