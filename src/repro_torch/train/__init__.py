"""Training: AdamW (`optimizer.py`), the train step with its cross-pod
gradient sync (`train_step.py`) and the WANify Trainer (`loop.py`)."""
