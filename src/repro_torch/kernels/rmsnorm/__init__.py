"""Fused RMSNorm: CUDA kernel K3 (``kernel``), plain twin (``ref``), entry
point over any leading shape (``ops``)."""
