"""Batched problem-structure operations and the hand-written kernels."""
