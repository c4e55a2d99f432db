"""Test harness config: force JAX onto a virtual 8-device CPU mesh.

Tests run without an accelerator: Pallas kernels run in interpret mode, and
multi-device sharding tests use xla_force_host_platform_device_count (the
reference's analog is headless LLVMpipe CI, SURVEY.md §4.4). Set
FIGDRAW_TEST_GPU=1 to leave the platform alone on a machine with a GPU;
tests marked `gpu` need one and skip without it (the `gpu_device` fixture).
"""

import os
import sys

if os.environ.get("FIGDRAW_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# persistent XLA compile cache for the TEST harness: the suite's wall time is
# dominated by jit compiles. Same location rule as the library
# (utils/jaxcache.py): JAX_COMPILATION_CACHE_DIR as given, else the fixed
# directory inside the checkout. A cache populated and read on the SAME host
# is safe for CPU artifacts too.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from figdraw_tpu.utils.jaxcache import cache_dir  # noqa: E402

os.makedirs(cache_dir(), exist_ok=True)
import jax  # noqa: E402

jax.config.update("jax_compilation_cache_dir", cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import pytest  # noqa: E402

# Every XLA:CPU executable JIT-maps ~6 VMAs (r--p/r-xp/rw-p triples) that live
# until jax.clear_caches(); the full suite compiles enough signatures to cross
# the kernel's vm.max_map_count (default 65530), at which point a failed mmap
# inside deserialize_executable SEGFAULTS the process (observed
# deterministically at test_sharded_perf, ~392 tests in: 65321 maps right
# before the crash). Clearing between modules once the map count passes 70%
# of the limit keeps the process far from the cliff; the persistent compile
# cache (above) makes the re-compiles cheap cache reads.
def _map_clear_threshold():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read()) * 7 // 10
    except (OSError, ValueError):
        return 45_000


_MAP_CLEAR_THRESHOLD = _map_clear_threshold()


def _vma_count():
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux: no /proc — never trigger
        return 0


@pytest.fixture(autouse=True, scope="module")
def _jax_map_pressure_relief():
    if _vma_count() > _MAP_CLEAR_THRESHOLD:
        import gc

        import jax

        jax.clear_caches()
        gc.collect()
    yield


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time — never while test modules are imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
