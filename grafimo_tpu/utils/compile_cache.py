"""Where JAX keeps its persistent compilation cache."""

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    no other directory is set here.  Otherwise the cache lives at the
    fixed path ``<checkout>/.jax_cache`` (git-ignored) — fixed because
    the path is part of the cache key, so a moving directory never hits.
    Call before the first compile of the process.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    loc = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", loc)
    return loc
