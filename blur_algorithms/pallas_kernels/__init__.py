"""Pallas GPU kernels for the hot compute paths."""
