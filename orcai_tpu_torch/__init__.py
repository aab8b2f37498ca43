"""orcAI on PyTorch and CUDA for NVIDIA Hopper: predict, data production,
train and test.

A port of the JAX package `orcai_tpu` that keeps its module names, so each
module here has a counterpart there: io (wav, json, tables, zarr stores,
flax checkpoints), models (the three architectures), ops (frontend,
overlap-add inference and the hand-written CUDA kernels under csrc/),
pipeline (predict, serve, recording tables, spectrograms, labels,
snippets), train, native (the host C codecs: LZ4, the wire encoders, the
resamplers of the spectral wires) and utils.

Entry points take an explicit `device` argument that defaults to "cuda" and
raise when CUDA is missing; the CPU runs only when the caller asks for it
with device="cpu". Nothing here imports jax, flax, pandas, zarr or msgpack.
"""

__version__ = "0.6.0"  # the version of the package it ports
