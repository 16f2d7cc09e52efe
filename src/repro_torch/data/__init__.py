"""Token data sources for training."""
