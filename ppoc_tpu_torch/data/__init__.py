"""Trajectory buffer."""
