"""Online predictor lifecycle (only the gate is ported so far)."""
