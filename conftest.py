"""Build both packages' native list builders once, before any test runs.

Under xdist the controller runs ``pytest_configure`` before it starts the
workers, so every worker finds finished libraries instead of compiling them
at once; the lock in ``build/`` also serialises two pytest runs on one tree.
The imports stay inside the hook: ``tests/conftest.py`` must set up JAX's
CPU mesh before anything imports JAX.
"""

import fcntl
import os

_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def pytest_configure(config):
    try:
        from ferreus_rbf_tpu import native as jax_native
        from ferreus_rbf_tpu_torch import native as torch_native
    except ImportError:
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jax_native.native_available()
        torch_native.native_available()
