"""PyTorch/CUDA port of mvpnet_tpu: MVPNet3D chunk inference, whole-scene
evaluation and training.

Runs on an NVIDIA H100 through hand-written CUDA kernels (``csrc/``) and on
the CPU, through the kernels' plain PyTorch versions, when the caller asks.
The JAX package ``mvpnet_tpu`` is the reference it is tested against; this
package imports nothing of it.
"""
