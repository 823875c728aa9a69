"""Fault plane (only the gate is ported so far)."""
