"""Measurement scripts for the port, run on a GPU host."""
