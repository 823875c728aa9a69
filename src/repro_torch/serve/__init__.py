"""repro_torch.serve — the batched serving engine."""
