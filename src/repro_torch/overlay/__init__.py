"""Overlay routing (only the gate is ported so far)."""
