"""Benchmark and experiment tooling of the port (the reference's L6/L7
layers): the ``bench`` headline line (``headline.py``), the BASELINE
configs (``baseline.py``), the scaling sweeps (``sweeps.py``) and the
plots (``plots.py``).  Each measurement runs on the card unless the
caller passes ``--device cpu``; none falls back to the CPU."""

from __future__ import annotations


class DeviceUnavailable(RuntimeError):
    """The measurement names the card and this machine has none."""


def measurement_device(name: str):
    """The torch device ``name`` names (``cuda`` -> ``cuda:0``); raises
    :class:`DeviceUnavailable` for a CUDA device when torch sees no card,
    so no result is ever measured somewhere else than asked."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                f"--device {name}: torch.cuda.is_available() is False; "
                "pass --device cpu to run the kernels' plain twins on the "
                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def card_info(device) -> tuple:
    """(name, power limit) of the card as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    (None, None) off the card."""
    import subprocess

    if device.type != "cuda":
        return None, None
    proc = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        import torch

        return torch.cuda.get_device_name(device), "not read"
    name, _, limit = proc.stdout.strip().splitlines()[0].partition(",")
    return name.strip(), limit.strip()
