"""Host-side utilities of the port: checkpoints, event files, post-processing."""
