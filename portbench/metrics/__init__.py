"""Per-layer readers: ``<metric>.py`` defines ``read(ctx)``, which takes
a :class:`portbench.harness.Context` and returns the metric's value, or
None when it finds nothing to read."""
