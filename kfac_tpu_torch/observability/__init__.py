"""Telemetry of the PyTorch port (the run-ledger header only, so far)."""
