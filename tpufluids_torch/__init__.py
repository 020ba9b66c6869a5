"""tpufluids_torch: the port of tpufluids to PyTorch and CUDA.

``tpufluids_torch.grid.stam`` holds the 3D stable-fluids step with the
spectral (DCT) projection; its stencil stages are hand-written CUDA
kernels (``tpufluids_torch.grid.kernels``).  ``tpufluids_torch.step``
holds the SPH base step (``scenes.base_dam`` -> ``step.run_python``);
its pair-force pass is a hand-written CUDA kernel
(``tpufluids_torch.sph_kernels``).  Kernel sources are in ``csrc/``,
built by ``tpufluids_torch._build``.  The package imports torch and
never JAX or the ``tpufluids`` package.
"""
