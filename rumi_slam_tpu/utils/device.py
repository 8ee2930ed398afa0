"""The device a measurement runs on: a GPU or nothing.

Measurement entry points (``chip_smoke.py``, ``bench.py``) call
:func:`require_gpu` first.  There is no CPU fallback: a number taken on the
CPU is never reported under a device metric.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return ``jax.devices()`` when the first device is a GPU; otherwise
    raise SystemExit (non-zero exit, no result printed)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this entry point measures the GPU only")
    return devs


def describe(devs) -> dict:
    """Platform, device kind and count as JAX reports them."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the visible cards:
    the card's name and power limit belong beside every number taken."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
