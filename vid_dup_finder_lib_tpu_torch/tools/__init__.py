"""Measurement scripts for the port's kernels, run as files on the card."""
