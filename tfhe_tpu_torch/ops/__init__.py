"""Kernels and exact integer contractions of the port."""
