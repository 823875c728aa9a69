"""repro_torch.launch — command-line launchers."""
