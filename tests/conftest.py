import os

# Tests run on the CPU with 8 virtual devices, so the multi-device paths run
# here; the GPU is exercised by chip_smoke.py and bench.py.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# reference fixtures: the real checkout when present, else the vendored
# byte-identical copies (tests/fixtures/) so hosted CI runs the same tests
import os as _os
_here = _os.path.dirname(_os.path.abspath(__file__))
if _os.path.isdir("/root/reference/test"):
    REFERENCE_TEST_DIR = "/root/reference/test"
    REFERENCE_SCRIPTS_DIR = "/root/reference/scripts"
else:
    REFERENCE_TEST_DIR = _os.path.join(_here, "fixtures")
    REFERENCE_SCRIPTS_DIR = _os.path.join(_here, "fixtures")
