"""Calibration and profiling scripts of the port, run as modules
(``python -m nbody_tpu_torch.scripts.<name>``) so that the package
resolves from the checkout, never from a build directory of the same
name."""
