"""PyTorch/CUDA port of the BF-IO serving system (reference: the JAX
package ``repro``).

Module for module it mirrors ``repro``: same file names, same public
names.  It imports neither ``jax`` nor ``repro``; the host-side numpy
modules are carried over as copies.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on a CUDA tensor every kernel wrapper
launches its hand-written Hopper kernel (``kernels/csrc``) or raises.
"""
