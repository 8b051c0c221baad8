"""laser_slam_tpu — a 2D laser SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
reference C++ stack (rising-turtle/laser_slam): polar scan matching,
polar/point-to-line ICP, occupancy-grid mapping, pose-graph SLAM with
loop closure, particle-filter localization, multi-sensor fusion, and a
multi-chip execution path over ``jax.sharding`` meshes.
"""

__version__ = "0.2.0"

import os as _os

# Where the persistent compilation cache lives when JAX_COMPILATION_CACHE_DIR
# is not set: a fixed path inside the checkout, because the path is part
# of the cache key and a cache that moves never hits.
CHECKOUT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache (SLAM programs are large
    and cold compiles take tens of seconds; warm runs must not pay again).

    A directory already configured -- ``JAX_COMPILATION_CACHE_DIR``, which
    JAX reads itself, or an embedding application's own setting -- is kept
    and no other is set; otherwise the cache goes to
    :data:`CHECKOUT_CACHE_DIR`. JAX's own thresholds for what it caches
    are left as they are."""
    import jax as _jax

    if not _jax.config.jax_compilation_cache_dir:
        _jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)


enable_compilation_cache()

from .core import se2
from .core.scan import LaserModel, Scan, LMS151, LMS211, LMS511, PRESETS

__all__ = [
    "enable_compilation_cache",
    "se2",
    "LaserModel",
    "Scan",
    "LMS151",
    "LMS211",
    "LMS511",
    "PRESETS",
]
