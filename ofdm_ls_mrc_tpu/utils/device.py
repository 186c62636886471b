"""What the program runs on: the device as JAX reports it, and the card.

Every measurement names its device (``describe``), and every measurement
path refuses to run anywhere but a GPU (``require_gpu``): a number taken on
the CPU backend is never reported as a device number.
"""

from __future__ import annotations

import os
import subprocess

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def card_info() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line, or
    a note saying why it could not be read."""
    try:
        r = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown (nvidia-smi: {e})"
    if r.returncode != 0:
        return f"unknown (nvidia-smi exit {r.returncode})"
    return r.stdout.strip()


def describe() -> dict:
    """Platform, device kind and count as JAX reports them, plus XLA_FLAGS."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "xla_flags": os.environ.get("XLA_FLAGS", "")}


def require_gpu(what: str) -> dict:
    """``describe()``, or SystemExit when JAX's first device is not a GPU."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(f"{what} measures an NVIDIA GPU; JAX found platform "
                         f"{dev['platform']!r} ({dev['kind']}) -- refusing "
                         f"to report a CPU number as a device number")
    return dev
