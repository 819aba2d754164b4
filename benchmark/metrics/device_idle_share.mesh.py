"""Share of the traced window in which no device operation ran (mesh
cells)."""

from benchmark.readers import idle_share as read  # noqa: F401
