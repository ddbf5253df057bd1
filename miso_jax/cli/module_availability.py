"""`module_availability` -- dependency probe.
Parity: misopy/module_availability.py:11-56 (adapted to the JAX stack)."""
from __future__ import annotations

import sys

MODULES = ["numpy", "scipy", "jax", "matplotlib"]


def main(argv=None) -> int:
    unavailable = 0
    print("Checking availability of Python modules for miso_jax")
    for mod in MODULES:
        try:
            __import__(mod)
            print("  - %s: available" % mod)
        except ImportError:
            print("  - %s: NOT available" % mod)
            unavailable += 1
    try:
        import jax
        print("JAX backend: %s, %d device(s)"
              % (jax.default_backend(), len(jax.devices())))
    except Exception as e:
        print("JAX device init failed: %s" % e)
        unavailable += 1
    if unavailable == 0:
        print("All modules available!")
    return unavailable


if __name__ == "__main__":
    sys.exit(main())
