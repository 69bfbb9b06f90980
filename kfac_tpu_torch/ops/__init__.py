"""Tensor ops and the hand-written kernels' wrappers."""
