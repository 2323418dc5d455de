"""Integrators and the fused CUDA MJHMC engine."""
