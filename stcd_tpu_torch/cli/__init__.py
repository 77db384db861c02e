"""Command-line entry points (counterparts of scripts/predict.py and scripts/serve.py)."""
