"""The GPU a run or a measurement uses."""

from __future__ import annotations

import subprocess


def require_gpu():
    """(device, card): JAX's first device as {"platform", "kind", "count"}
    and the card's name and power limit as nvidia-smi reports them. Exits
    non-zero when the first device is not a GPU: runs on the card never
    fall back to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}, card
