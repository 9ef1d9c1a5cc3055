"""Kernel build and launch bookkeeping (see kernels/build.py)."""
