"""ACAR (adaptive complexity routing over a multi-model ensemble),
ported to PyTorch and CUDA for NVIDIA Hopper.

A package of its own beside the JAX reference (``repro``), with the
same subpackage names so each counterpart is found by name. It imports
torch, numpy and the standard library, and never jax or ``repro``.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel runs its plain PyTorch version.
"""
