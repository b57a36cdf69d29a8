"""The dense- and MoE-family language models of the port: layers
(``layers``), the MoE layer (``moe``), the decoder stack (``model``) and
parameters carried over from the JAX package (``convert``)."""
