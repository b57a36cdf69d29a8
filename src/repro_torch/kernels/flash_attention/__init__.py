"""Flash attention: CUDA kernel K4 (``kernel``), plain twin (``ref``),
public entry point with the JAX package's contract (``ops``)."""
