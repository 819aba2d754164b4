"""End-to-end examples that drive the port's CLI (``run`` then ``plot``;
``plot`` needs matplotlib)."""
