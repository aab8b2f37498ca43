"""orcAI on PyTorch and CUDA: the `orcai predict` path for NVIDIA Hopper.

A port of the JAX package `orcai_tpu` that keeps its module names, so each
module here has a counterpart there: io (wav, json, flax checkpoints),
models (ResNetLSTM), ops (frontend, overlap-add inference and the two
hand-written CUDA kernels under csrc/), pipeline (predict) and utils.

Entry points take an explicit `device` argument that defaults to "cuda" and
raise when CUDA is missing; the CPU runs only when the caller asks for it
with device="cpu". Nothing here imports jax, flax, pandas or msgpack.
"""
