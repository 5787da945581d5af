"""xframe_tpu_torch — the FXS phasing system on PyTorch and CUDA.

A port of `xframe_tpu` (JAX) to PyTorch, with the spherical-harmonic
transforms of the MTIP phasing loop written by hand in CUDA C++ for Hopper
(`csrc/sht.cu`). The layout follows the JAX package: `library/` holds host
table builders, `ops/` the transforms, `projects/fxs/` the workers, the
projections, the phasing loop and the synthetic demo problem,
`projects/tutorial/` the tutorial project, `settings/` the settings as
JSON, `io/` the VTK writer. It is started as the JAX package is:
`python -m xframe_tpu_torch <project> <worker> [settings]` (`main.py`).

The package imports torch, numpy and scipy only; it never imports jax,
PyYAML or `xframe_tpu`, so it runs on a machine that has none of them.
Tensors on the CPU take the plain PyTorch version of every kernel; tensors on
a CUDA device launch the kernels, which are compiled with nvcc on first use
(`ops/_build.py`).
"""

__version__ = "0.1.0"
