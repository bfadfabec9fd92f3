"""Where the program runs: the one device-capability query and the
persistent compilation cache.

Every choice that depends on the hardware (the condensation kernel, the
factory's engine) asks ``on_accelerator()`` and nothing else, so the code
has one notion of "the device" instead of comparisons of backend names
scattered through the modules."""

import os

import jax

# <repo>/.jax_cache: a fixed path inside the checkout (listed in .gitignore)
# — the path is part of the cache key, so it must not move between runs
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def on_accelerator() -> bool:
    """True when JAX's default backend is an accelerator, not the host
    CPU."""
    return jax.default_backend() != "cpu"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this sets nothing; otherwise the cache goes to ``DEFAULT_CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
