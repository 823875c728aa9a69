"""The synthetic data pipeline (`pipeline.py`)."""
