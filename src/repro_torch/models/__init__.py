"""The dense-, MoE-, SSM- and hybrid-family language models of the port:
layers (``layers``), the MoE layer (``moe``), the Mamba1 / Mamba2 blocks
(``mamba``), the decoder stack (``model``) and parameters carried over
from the JAX package (``convert``)."""
