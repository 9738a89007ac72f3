"""PyTorch / CUDA port of ttl_tpu for one NVIDIA H100.

The JAX package `ttl_tpu` is the reference; this package imports torch and
never jax. It reuses the JAX package's JAX-free modules: the config, the CLI
parser, the data loaders, the class names and the BPE tokenizer.
"""
