"""Compute kernels: host-exact reference semantics, the hand-written CUDA
kernels of the encode and decode paths with their plain-torch twins, and
the device stages around them."""
