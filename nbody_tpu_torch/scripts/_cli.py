"""Argument handling shared by the scripts: ``key=value,...`` specs and
``--device`` (the card unless the caller asks for the CPU)."""

from __future__ import annotations

import argparse


def parse(argv, prog: str, doc: str, default_specs=()):
    """(torch device, [spec dict, ...]) from ``argv``; exits 1 when the
    device is the card and there is none."""
    from ..bench import DeviceUnavailable, measurement_device

    ap = argparse.ArgumentParser(
        prog=prog, description=doc,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("specs", nargs="*", default=list(default_specs),
                    help="key=value,... (see the module docstring)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain twins)")
    args = ap.parse_args(argv)
    try:
        device = measurement_device(args.device)
    except DeviceUnavailable as e:
        ap.exit(1, f"{prog}: {e}\n")
    specs = [dict(kv.split("=", 1) for kv in spec.split(","))
             for spec in args.specs or default_specs]
    return device, specs
