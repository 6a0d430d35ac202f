"""The dual-branch encoder/decoder family as torch modules (NCHW)."""
