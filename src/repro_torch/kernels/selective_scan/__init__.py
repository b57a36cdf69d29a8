"""Mamba1's selective scan: CUDA kernel K5 (``kernel``), plain twin
(``ref``), entry point that refuses autograd on CUDA (``ops``)."""
