"""PyTorch/CUDA port of ``pytorch_distributedtraining_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: each module here names
its counterpart there, keeps the same public layouts (NHWC images,
``[B*nW, heads, n, d]`` attention tiles) and is held against it by the CPU
tests in ``tests/test_torch_*.py``. The port imports neither JAX nor the JAX
package. Its Pallas kernels become hand-written CUDA kernels under
``csrc/``, built at first use; every kernel has a plain PyTorch version
that CPU tensors take.

This slice covers the SwinIR-S x2 training path of ``drivers/stoke_ddp.py``
on one GPU: ``ops``, ``models``, ``interop``, ``losses``, ``metrics``,
``optim``, ``precision``, ``runtime``, ``data``, ``checkpoint``,
``observe``, ``stoke`` and ``drivers.stoke_ddp``.
"""
