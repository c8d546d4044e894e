"""Compute kernels: host-exact reference semantics, the hand-written CUDA
kernels of the encode path, and their plain-torch twins."""
