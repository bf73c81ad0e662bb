"""The device a measurement runs on, named the way results report it."""
from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices; raises
    SystemExit unless they are GPUs (a device measurement never falls back
    to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default platform is "
                         f"{devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """`nvidia-smi` name and power limit of each card, one per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
