"""Runtime of the port: the stitch pipeline."""
