"""The WAN model: 8-DC topology, contention simulator, snapshot
monitoring and the forest's training data (port of `repro/wan/`)."""
