"""PyTorch/CUDA port of the Arabesque graph-mining system (the JAX package
``repro`` is the reference). It imports neither JAX nor the JAX package."""
