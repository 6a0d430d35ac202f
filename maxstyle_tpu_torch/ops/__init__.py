"""Tensor ops of the port: intensity normalisation, MaxStyle, the warp."""
