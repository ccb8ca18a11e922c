"""What the device path may assume about the JAX backend.

One capability check decides whether an accelerator is attached
(`accelerator_present`), one helper places XLA's persistent compile
cache (`use_compile_cache`), one reader takes the package's environment
knobs (`knob`), and one constant fixes the precision of every float32
matrix product on the pixel path (`PRECISION`).
"""

from __future__ import annotations

import os
from typing import Optional

import jax

# On a GPU a float32 product at DEFAULT or HIGH precision may run in
# TF32 (about three decimal digits), which breaks the 1-code contract
# of the lossy decode against the float64 host oracle.  Every pixel-path
# dot_general reads this constant at trace time.
PRECISION = jax.lax.Precision.HIGHEST

# The compile cache's fixed place when JAX_COMPILATION_CACHE_DIR is not
# set: inside the checkout (listed in .gitignore), so its path, which
# is part of the cache key, never moves.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")

# The environment knobs this package reads.
KNOBS = ("JXL_DEVICE", "JXL_ENC_DEVICE", "JXL_ENTROPY",
         "JXL_MODULAR_DEVICE", "JXL_NO_NATIVE")

# Knobs that are gone, with what replaces each.  Earlier releases
# spelled every knob with one more word after "JXL_"; a name of that
# form that maps onto a current or removed knob is refused, so a
# setting that is no longer read never goes unnoticed.
REMOVED_KNOBS = {
    "JXL_DEVICE_STRICT": "nothing: device failures always raise",
    "JXL_ENTROPY_STRICT": "nothing: device failures always raise",
    "JXL_SYNTH_PALLAS": "nothing: the synthesis is the einsum path",
    "JXL_XLA_CACHE": "JAX_COMPILATION_CACHE_DIR",
}


def _check_knob_names() -> None:
    for key in os.environ:
        if not key.startswith("JXL_") or key in KNOBS:
            continue
        new = "JXL_" + key[4:].partition("_")[2]
        if new in KNOBS:
            raise RuntimeError(f"{key} is no longer read; set {new}")
        if new in REMOVED_KNOBS or key in REMOVED_KNOBS:
            gone = new if new in REMOVED_KNOBS else key
            raise RuntimeError(f"{key} is no longer read; use "
                               f"{REMOVED_KNOBS[gone]}")


def knob(name: str, default: Optional[str] = None) -> Optional[str]:
    """The value of environment knob `name` (one of KNOBS).  Raises
    when the environment sets a knob name this package no longer
    reads."""
    assert name in KNOBS, name
    _check_knob_names()
    return os.environ.get(name, default)


def accelerator_present() -> bool:
    """True when JAX's default device is an accelerator.

    JAX itself falls back to the CPU when an accelerator plugin fails
    to initialise, so a card that did not come up reads as absent here;
    errors raised by JAX are not swallowed."""
    return jax.devices()[0].platform != "cpu"


def use_compile_cache() -> Optional[str]:
    """Turn on XLA's persistent compile cache and return its directory.

    The device path calls this before it builds each jitted program, so
    a fresh process reloads what an earlier one compiled.  Where
    JAX_COMPILATION_CACHE_DIR is set, or the caller already gave JAX a
    cache directory, nothing is changed here.  Otherwise the cache goes
    to CACHE_DIR, unless the checkout is read-only: then no cache is
    kept and None is returned."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    if not os.access(os.path.dirname(CACHE_DIR), os.W_OK):
        return None
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
