"""The accelerator a measurement runs on: refuse anything but a GPU, and
describe the card the way every recorded number names it."""

from __future__ import annotations

import subprocess


def require_gpu(devices) -> list:
    """Raise unless every device is a GPU: a measurement never falls back to
    the CPU."""
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise RuntimeError(
            f"no GPU: JAX devices are on {platforms}; this needs an NVIDIA GPU"
        )
    return list(devices)


def nvidia_smi_cards() -> list[str]:
    """``name, power.limit`` of each card as ``nvidia-smi`` prints them (a
    child process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_record(devices) -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
