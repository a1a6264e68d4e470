"""A fixture for every test module of the repository.

XLA keeps a compiled executable's JIT code mapped in memory while any cache
holds the executable. One pytest-xdist worker that runs several
compile-heavy modules in turn can reach the kernel's limit on memory
mappings (``vm.max_map_count``, 65530), and XLA's next compile there then
segfaults. So each module's compiled executables are released when the
module ends.
"""
import gc
import sys

import pytest


@pytest.fixture(scope="module", autouse=True)
def release_compiled():
    """Clears JAX's compile caches when the module ends (a module run in a
    process that never imported jax has nothing to release)."""
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
