"""Decode attention over a KV cache: CUDA kernel K6 (``kernel``), plain
twin (``ref``), entry point (``ops``)."""
