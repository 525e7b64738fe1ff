"""The plain reference the benchmark holds the port to.

Plain PyTorch and NumPy only: nothing here imports ``jax``, the JAX package or
anything of the port. ``fusion`` fuses translated tiles, ``pyramid`` builds
the OME-Zarr resolution levels, ``registration`` judges resolved tile
positions against the generator's truth, and ``compare`` gives the numbers
that decide ``correct``.
"""
