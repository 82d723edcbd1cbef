"""Command-line launchers, the device meshes and their axes trees, and
the analytic FLOP and byte model."""
