"""tpufluids_torch: the port of tpufluids to PyTorch and CUDA.

``tpufluids_torch.grid.stam`` holds the 3D stable-fluids step with the
spectral (DCT) projection; its stencil stages are hand-written CUDA
kernels (``tpufluids_torch.grid.kernels``, sources in ``csrc/``).  The
package imports torch and never JAX or the ``tpufluids`` package.
"""
